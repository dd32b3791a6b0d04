"""Bitonic key/value sort — the counterpart of
``water_sandbox_tpu/ops/pallas/bitonic_sort.py``.

``sort_pairs`` sorts int32 (key, value) pairs by key, ascending, through
the same compare-exchange network as the TPU kernel, so keys and values
(ties included) equal the JAX package's bit for bit. Non-power-of-two n
pads with INT32_MAX keys to ``max(1024, 2^ceil(log2 n))``; more than 65,536
padded pairs raise, as in the JAX package. On a CUDA tensor it launches
``csrc/bitonic_sort.cu`` once (the kernel makes the padding itself and
writes the n sorted pairs into two fresh tensors) and counts the call in
``LAUNCHES``; on a CPU tensor it runs ``sort_pairs_plain``, the same network
in torch ops.
"""

from __future__ import annotations

import torch

_LANES = 128
_KEY_MAX = 2**31 - 1
MAX_PAIRS = 65536

# Calls that launched the kernel (see sph_bucket.LAUNCHES).
LAUNCHES = {"bitonic_sort": 0}


def reset_launches() -> None:
    LAUNCHES["bitonic_sort"] = 0


def _n_pad(keys: torch.Tensor, values: torch.Tensor) -> int:
    """The padded length max(1024, 2^ceil(log2 n)); raises on what the
    kernel does not take."""
    if keys.dim() != 1 or values.shape != keys.shape:
        raise ValueError(f"keys and values must be 1-D of one length; got "
                         f"{tuple(keys.shape)} and {tuple(values.shape)}")
    if keys.device != values.device:
        raise ValueError("keys and values must share one device")
    n = keys.shape[0]
    n_pad = max(_LANES * 8, 1 << (n - 1).bit_length())
    if n_pad > MAX_PAIRS:
        raise ValueError(f"n={n} too large for the bitonic sort (max "
                         f"{MAX_PAIRS})")
    return n_pad


def _padded(keys: torch.Tensor, values: torch.Tensor):
    """(keys, values) as int32, padded with (INT32_MAX, 0) to n_pad."""
    n = keys.shape[0]
    n_pad = _n_pad(keys, values)
    keys_p = torch.full((n_pad,), _KEY_MAX, dtype=torch.int32,
                        device=keys.device)
    keys_p[:n] = keys
    vals_p = torch.zeros(n_pad, dtype=torch.int32, device=keys.device)
    vals_p[:n] = values
    return keys_p, vals_p


def _network(keys: torch.Tensor, vals: torch.Tensor):
    """The TPU kernel's stages on padded tensors (bitonic_sort.py:63-79)."""
    n_pad = keys.shape[0]
    idx = torch.arange(n_pad, device=keys.device)
    d = 2
    while d <= n_pad:
        k = d // 2
        while k >= 1:
            partner = idx ^ k
            pk, pv = keys[partner], vals[partner]
            want_min = ((idx & k) == 0) == ((idx & d) == 0)
            take = (want_min & (pk < keys)) | (~want_min & (pk > keys))
            keys = torch.where(take, pk, keys)
            vals = torch.where(take, pv, vals)
            k //= 2
        d *= 2
    return keys, vals


def sort_pairs_plain(keys: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch version of the kernel. Returns (keys, values) of the
    original length n."""
    n = keys.shape[0]
    k, v = _network(*_padded(keys, values))
    return k[:n], v[:n]


def sort_pairs(keys: torch.Tensor, values: torch.Tensor):
    """Sort int32 (keys, values) by key, ascending. Returns (keys, values)
    of the original length n. Plain version on the CPU, kernel on CUDA."""
    if keys.device.type == "cpu":
        return sort_pairs_plain(keys, values)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n_pad = _n_pad(keys, values)
    # no-ops for contiguous int32 input, the kernel's own type
    keys = keys.to(torch.int32).contiguous()
    values = values.to(torch.int32).contiguous()
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(values)
    from . import _build
    err = _build.entry("wst_bitonic_sort")(
        keys.data_ptr(), values.data_ptr(), out_k.data_ptr(),
        out_v.data_ptr(), keys.shape[0], n_pad, keys.device.index or 0,
        torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitonic_sort kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["bitonic_sort"] += 1
    return out_k, out_v


def argsort_keys(keys: torch.Tensor):
    """Sort a permutation by cell keys. Returns (sorted_keys, order)."""
    order = torch.arange(keys.shape[0], dtype=torch.int32,
                         device=keys.device)
    return sort_pairs(keys, order)
