"""The reference HUD keymap, as a pure key → parameter-update map — a copy
of ``water_sandbox_tpu/runtime/keymap.py`` (that module imports no JAX, but
its package does).

Mirrors the reference's update_fluid_props (hud.rs:130-165) key for key;
every step is FLUID_PROPS_CHANGE_STEP = 0.1 (hud.rs:11):

    1/2  smoothing radius −/+   (guarded > 0, hud.rs:135)
    Q/W  pressure scalar  −/+
    A/S  near-pressure    −/+
    Z/X  target density   −/+
    3/4  gravity.y        +/−   (3 raises toward 0, hud.rs:151-154)
    E/R  viscosity        −/+
    0    gravity off (set_zero,    gravity.rs:24-27)
    9    gravity on  (set_default, gravity.rs:29-32)

plus the app-shell keys: Space = scene reset (fluid_compute.rs:505-525),
Esc/p = pause toggle (state.rs:34-40). Used by the live TUI (viz/live.py)
and the web viewer (viz/server.py). ``Simulation.tune`` copies into the
parameter buffers the step reads, under the Simulation's lock, so every
change applies from the next step; a caller on another thread holds
``sim.lock`` around ``apply_key``, so the values it reads are the ones it
changes.
"""

from __future__ import annotations

KEY_STEP = 0.1  # FLUID_PROPS_CHANGE_STEP (hud.rs:11)

HELP = ("1/2 radius  q/w pressure  a/s near-prs  z/x density  e/r viscosity  "
        "3/4 gravity  0/9 g-off/on  space reset  p/esc pause")


def apply_key(sim, key: str) -> str | None:
    """Apply one key press to a Simulation. Returns a description of the
    action taken, or None if the key is unbound."""
    p = sim.params
    k = key.lower()
    if k == "1":
        new = float(p.smoothing_radius) - KEY_STEP
        if new <= 0.0:  # hud.rs:135 guard
            return "smoothing radius at minimum"
        sim.tune(smoothing_radius=new)
        return f"smoothing_radius -> {new:.2f}"
    if k == "2":
        new = float(p.smoothing_radius) + KEY_STEP
        sim.tune(smoothing_radius=new)
        return f"smoothing_radius -> {new:.2f}"
    simple = {
        "q": ("pressure_scalar", -KEY_STEP),
        "w": ("pressure_scalar", +KEY_STEP),
        "a": ("near_pressure_scalar", -KEY_STEP),
        "s": ("near_pressure_scalar", +KEY_STEP),
        "z": ("target_density", -KEY_STEP),
        "x": ("target_density", +KEY_STEP),
        "e": ("viscosity_strength", -KEY_STEP),
        "r": ("viscosity_strength", +KEY_STEP),
    }
    if k in simple:
        name, delta = simple[k]
        new = float(getattr(p, name)) + delta
        sim.tune(**{name: new})
        return f"{name} -> {new:.2f}"
    if k in ("3", "4"):
        g = [float(x) for x in p.gravity]
        g[1] += KEY_STEP if k == "3" else -KEY_STEP  # hud.rs:151-154
        sim.tune(gravity=g)
        return f"gravity.y -> {g[1]:.2f}"
    if k == "0":
        sim.gravity_off()
        return "gravity off"
    if k == "9":
        sim.gravity_on()
        return "gravity on"
    if k == " ":
        sim.reset()
        return "scene reset"
    if k in ("p", "\x1b"):
        sim.pause()
        return f"phase -> {sim.phase.value}"
    return None


def params_line(sim) -> str:
    """The HUD readout row (hud.rs:64-127): the 6 live parameters."""
    p = sim.params
    return (f"h={float(p.smoothing_radius):.2f} "
            f"k={float(p.pressure_scalar):.1f} "
            f"k_near={float(p.near_pressure_scalar):.1f} "
            f"rho0={float(p.target_density):.1f} "
            f"mu={float(p.viscosity_strength):.2f} "
            f"g={float(p.gravity[1]):.1f}")
