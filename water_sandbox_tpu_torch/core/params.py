"""Simulation parameters — the PyTorch counterpart of
``water_sandbox_tpu/core/params.py``.

Runtime-tunable physics lives in :class:`SimParams`, a frozen dataclass of
float32 tensors on one device (every field is read by the step on the
device, so tuning between steps never copies state). Shape-determining
facts live in :class:`SimConfig`, whose field names and values are the JAX
package's, so a JAX checkpoint's ``config_json`` loads unchanged.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import device as device_mod

# Defaults mirror the reference solver constants (same values as the JAX
# package).
DEFAULT_PARTICLE_RADIUS = 0.1
DEFAULT_COLLISION_DAMPING = 0.95
DEFAULT_SMOOTHING_RADIUS = 0.25
DEFAULT_TARGET_DENSITY = 10.0
DEFAULT_PRESSURE_SCALAR = 22.0
DEFAULT_NEAR_PRESSURE_SCALAR = 2.0
DEFAULT_VISCOSITY_STRENGTH = 0.1
DEFAULT_DT = 1.0 / 60.0
DEFAULT_LOOKAHEAD = 1.0 / 50.0
DEFAULT_GRAVITY_Y = -9.8
DEFAULT_CONTAINER_SIZE = (16.0, 9.0, 9.0)
DENSITY_PADDING = 1e-5


def _t(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _map_tensors(obj, fn):
    """Apply ``fn`` to every tensor field of a (nested) params dataclass."""
    return dataclasses.replace(obj, **{
        f.name: (fn(v) if isinstance(v, torch.Tensor) else _map_tensors(v, fn))
        for f in dataclasses.fields(obj)
        for v in [getattr(obj, f.name)]})


@dataclasses.dataclass(frozen=True)
class Container:
    """Axis-aligned box stored as center + half size; it may translate with
    ``velocity`` and yaw about its center at ``angular_velocity`` rad/s
    (about +z in 2-D, +y in 3-D)."""

    center: torch.Tensor            # (dim,)
    half_size: torch.Tensor         # (dim,)
    velocity: torch.Tensor          # (dim,)
    angular_velocity: torch.Tensor  # ()
    angle: torch.Tensor             # ()

    @staticmethod
    def create(center=(0.0, 0.0, 0.0), size=DEFAULT_CONTAINER_SIZE,
               velocity=None, angular_velocity=0.0, angle=0.0,
               device=device_mod.DEFAULT) -> "Container":
        """On the card unless ``device`` says otherwise (``device="cpu"``
        for the CPU); raises without a CUDA device, as every constructor of
        the port does."""
        device = device_mod.resolve(device)
        center = _t(center, device)
        size = _t(size, device)
        velocity = (torch.zeros_like(center) if velocity is None
                    else _t(velocity, device))
        return Container(center=center, half_size=size / 2.0,
                         velocity=velocity,
                         angular_velocity=_t(angular_velocity, device),
                         angle=_t(angle, device))

    @property
    def dim(self) -> int:
        return self.center.shape[-1]

    def ext(self, padding):
        """(ext_min, ext_max) shrunk by ``padding``, in the local (unrotated)
        frame centered on ``center``."""
        return (self.center - self.half_size + padding,
                self.center + self.half_size - padding)

    @property
    def is_moving(self) -> torch.Tensor:
        """() bool: the box translates or spins."""
        return (self.velocity * self.velocity).sum() + (
            self.angular_velocity * self.angular_velocity) > 0


@dataclasses.dataclass(frozen=True)
class InteractionField:
    """Point attractor/repulsor: force ``strength * (1 - r/radius)`` along
    the radial direction within ``radius``; zero strength disables it."""

    position: torch.Tensor  # (dim,)
    strength: torch.Tensor  # ()
    radius: torch.Tensor    # ()

    @staticmethod
    def inactive(dim: int,
                 device=device_mod.DEFAULT) -> "InteractionField":
        device = device_mod.resolve(device)
        return InteractionField(position=torch.zeros(dim, device=device),
                                strength=_t(0.0, device),
                                radius=_t(1.0, device))

    @staticmethod
    def create(position, strength, radius,
               device=device_mod.DEFAULT) -> "InteractionField":
        device = device_mod.resolve(device)
        return InteractionField(position=_t(position, device),
                                strength=_t(strength, device),
                                radius=_t(radius, device))


@dataclasses.dataclass(frozen=True)
class SimParams:
    """All runtime-tunable physics parameters, as float32 tensors on one
    device. Field order is the JAX package's (``jax.tree.flatten`` order is
    what its checkpoints store; see ``core/convert.py``)."""

    dt: torch.Tensor
    collision_damping: torch.Tensor
    smoothing_radius: torch.Tensor
    target_density: torch.Tensor
    pressure_scalar: torch.Tensor
    near_pressure_scalar: torch.Tensor
    viscosity_strength: torch.Tensor
    lookahead: torch.Tensor
    particle_radius: torch.Tensor
    gravity: torch.Tensor        # (dim,)
    max_speed: torch.Tensor      # 0 = speed limiter off
    container: Container
    field: InteractionField

    @staticmethod
    def create(dim: int = 3, dt: float = DEFAULT_DT,
               collision_damping: float = DEFAULT_COLLISION_DAMPING,
               smoothing_radius: float = DEFAULT_SMOOTHING_RADIUS,
               target_density: float = DEFAULT_TARGET_DENSITY,
               pressure_scalar: float = DEFAULT_PRESSURE_SCALAR,
               near_pressure_scalar: float = DEFAULT_NEAR_PRESSURE_SCALAR,
               viscosity_strength: float = DEFAULT_VISCOSITY_STRENGTH,
               lookahead: float = DEFAULT_LOOKAHEAD,
               particle_radius: float = DEFAULT_PARTICLE_RADIUS,
               max_speed: float = 0.0, gravity=None,
               container: Container | None = None,
               field: InteractionField | None = None,
               device=device_mod.DEFAULT) -> "SimParams":
        """Parameters on the card unless ``device`` says otherwise
        (``device="cpu"`` for the CPU). A ``container`` or ``field`` passed
        in is moved to ``device``."""
        device = device_mod.resolve(device)
        if gravity is None:
            gravity = [0.0] * dim
            gravity[1] = DEFAULT_GRAVITY_Y
        if container is None:
            container = Container.create(center=[0.0] * dim,
                                         size=DEFAULT_CONTAINER_SIZE[:dim],
                                         device=device)
        if field is None:
            field = InteractionField.inactive(dim, device)
        return SimParams(
            dt=_t(dt, device), collision_damping=_t(collision_damping, device),
            smoothing_radius=_t(smoothing_radius, device),
            target_density=_t(target_density, device),
            pressure_scalar=_t(pressure_scalar, device),
            near_pressure_scalar=_t(near_pressure_scalar, device),
            viscosity_strength=_t(viscosity_strength, device),
            lookahead=_t(lookahead, device),
            particle_radius=_t(particle_radius, device),
            gravity=_t(gravity, device), max_speed=_t(max_speed, device),
            container=_map_tensors(container, lambda t: t.to(device)),
            field=_map_tensors(field, lambda t: t.to(device)))

    @property
    def dim(self) -> int:
        return self.gravity.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.dt.device

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **{
            k: (v if isinstance(v, (Container, InteractionField))
                else _t(v, self.device))
            for k, v in kw.items()})

    def to(self, device) -> "SimParams":
        return _map_tensors(self, lambda t: t.to(device))


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y by square-and-multiply in the order XLA's integer_pow uses, so
    the coefficients below equal the JAX package's bit for bit."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _coef(num: float, den_scale: float, hp: torch.Tensor) -> torch.Tensor:
    # num / (den_scale * hp) as a true division (``float / tensor`` in torch
    # multiplies by a reciprocal, which rounds differently)
    return torch.div(torch.full_like(hp, num), den_scale * hp)


# (num, den_scale, power) of each coefficient num / (den_scale * h**power),
# in KernelCoeffs' field order, by dim: the ATen chain and the CUDA kernel
# (ops/cuda/coeffs.py) read the same table.
_COEFF_TERMS = {
    3: ((15.0, 2.0 * math.pi, 5), (15.0, math.pi, 5), (15.0, math.pi, 6),
        (45.0, math.pi, 6), (315.0, 64.0 * math.pi, 9)),
    2: ((6.0, math.pi, 4), (12.0, math.pi, 4), (10.0, math.pi, 5),
        (30.0, math.pi, 5), (4.0, math.pi, 8)),
}


@dataclasses.dataclass(frozen=True)
class KernelCoeffs:
    """Smoothing-kernel normalization constants derived from the radius."""

    pow2: torch.Tensor        # density kernel   (h-d)^2
    pow2_der: torch.Tensor    # its derivative   (d-h) * pow2_der
    pow3: torch.Tensor        # near-density     (h-d)^3
    pow3_der: torch.Tensor    # its derivative   (d-h)^2 * pow3_der
    spikey_pow3: torch.Tensor  # viscosity/poly6 (h^2-d^2)^3

    @staticmethod
    def from_radius(h: torch.Tensor, dim: int) -> "KernelCoeffs":
        """The coefficients of the () radius ``h``: on a CUDA tensor one
        kernel (``ops/cuda/coeffs.py::run_coeffs``), on the CPU the ATen
        chain (``coeffs_plain``); both give the JAX package's bits."""
        if h.device.type != "cuda":
            return coeffs_plain(h, dim)
        from ..ops.cuda.coeffs import run_coeffs
        return KernelCoeffs(*run_coeffs(h, _terms(dim)))


def _terms(dim: int):
    terms = _COEFF_TERMS.get(dim)
    if terms is None:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    return terms


def coeffs_plain(h: torch.Tensor, dim: int) -> KernelCoeffs:
    """``KernelCoeffs.from_radius`` as the ATen chain, on any device: the
    CPU path, and on the card the yardstick of its kernel."""
    return KernelCoeffs(*(_coef(num, den_scale, _ipow(h, p))
                          for num, den_scale, p in _terms(dim)))


# TPU kernel-layout probe fields of the JAX SimConfig: accepted at these
# values only (the port has one kernel per pass and no probe variants).
_PROBE_DEFAULTS = {"build_scatter": "stack", "density_gate": (),
                   "force_gate": (), "dma_prefetch": True,
                   "flush_gated": True}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static shape-determining configuration (same fields as the JAX
    package's ``SimConfig``).

    ``neighbor_mode``: ``"auto"`` and ``"pallas"`` both mean the fused
    bucket-kernel pipeline (``ops/cuda/sph_bucket.py``) on every device —
    unlike the JAX package, which maps ``"auto"`` to its XLA ``bucket_grid``
    pipeline off-TPU. On a CUDA device the pipeline launches the hand
    kernels; on the CPU it runs their plain PyTorch versions.
    ``"dense"`` (the all-pairs oracle, ``ops/dense.py``), ``"bucket_grid"``
    and ``"hash_grid"`` (``ops/grid.py``) are plain PyTorch on the state's
    device. ``grid_frame="container"`` is honoured by the kernel pipeline
    and ``"bucket_grid"``; ``"dense"`` and ``"hash_grid"`` have no bounded
    grid to pose and ignore it, as the JAX package does (their hash keys
    stay world cells; the integrator still moves and yaws the box).
    ``incremental_rebuild > 0`` makes ``rollout`` in the kernel pipeline
    keep the particles resident in the bucket planes
    (``ops/cuda/incremental.py``).

    ``build_scatter``, ``density_gate``, ``force_gate``, ``dma_prefetch``
    and ``flush_gated`` are the JAX package's TPU probe knobs: accepted at
    their defaults, refused otherwise. ``tile_override`` stays: it shapes
    the bucket-plane layout.
    """

    n: int
    dim: int = 3
    neighbor_mode: str = "auto"
    grid_dims: tuple = ()
    cell_capacity: int = 16
    hash_table_size: int = 0
    max_run: int = 64
    chunk: int = 2048
    dtype: str = "float32"
    rescue_capacity: int = 0
    incremental_rebuild: int = 0
    mover_capacity: int = 0
    sorted_state: bool = False
    grid_frame: str = "world"
    tile_override: int = 0
    build_scatter: str = "stack"
    density_gate: tuple = ()
    force_gate: tuple = ()
    dma_prefetch: bool = True
    flush_gated: bool = True

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        if self.grid_frame not in ("world", "container"):
            raise ValueError(f"bad grid_frame {self.grid_frame!r}")
        if self.grid_frame == "container" and self.incremental_rebuild > 0:
            raise ValueError(
                "grid_frame='container' is incompatible with incremental "
                "bucket maintenance (the cache pins a frozen world anchor)")
        if self.tile_override and (self.tile_override % 256
                                   or self.tile_override < 256):
            raise ValueError("tile_override must be 0 or a multiple of 256")
        if self.neighbor_mode not in ("auto", "dense", "hash_grid",
                                      "bucket_grid", "pallas"):
            raise ValueError(f"bad neighbor_mode {self.neighbor_mode!r}")
        if self.sorted_state and self.neighbor_mode not in ("auto", "pallas"):
            raise ValueError(
                f"sorted_state=True requires neighbor_mode='pallas' (or "
                f"'auto'); got {self.neighbor_mode!r}")
        if self.sorted_state and self.incremental_rebuild > 0:
            raise ValueError(
                "sorted_state is incompatible with incremental_rebuild")
        for name, default in _PROBE_DEFAULTS.items():
            if getattr(self, name) != default:
                raise ValueError(
                    f"{name}={getattr(self, name)!r}: TPU kernel probe knob, "
                    f"the port accepts only its default {default!r}")
        if self.dtype != "float32":
            raise ValueError("the port runs float32 only")
        if self.neighbor_mode in ("auto", "bucket_grid", "pallas"):
            if len(self.grid_dims) != self.dim:
                raise ValueError(
                    f"neighbor_mode={self.neighbor_mode!r} needs grid_dims "
                    f"of length dim={self.dim} (got {self.grid_dims!r}); "
                    "derive them with hashing.default_grid_dims("
                    "container_size, smoothing_radius)")
            if any(d < 3 for d in self.grid_dims):
                raise ValueError(
                    f"grid_dims must each be >= 3, got {self.grid_dims!r}")

    def resolved(self) -> "SimConfig":
        """``"auto"`` names the fused-kernel pipeline (``"pallas"``) on every
        device; explicit modes resolve to themselves."""
        if self.neighbor_mode != "auto":
            return self
        return dataclasses.replace(self, neighbor_mode="pallas")

    @property
    def table_size(self) -> int:
        """Hash-table size of ``hash_grid`` mode (0 = n, as the reference)."""
        return self.hash_table_size or self.n

    @property
    def num_neighbor_cells(self) -> int:
        return 3**self.dim
