"""Which device a measurement ran on.

Every number the GPU entry points print (``bench.py``, ``chip_smoke.py``)
names its device: JAX's view of it and the card's own name and power
limit as ``nvidia-smi`` reports them. A measurement path that finds no
GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


class NoGPUError(RuntimeError):
    """JAX's default backend is not a CUDA GPU."""


def device_info(backend: str, devices) -> dict:
    """``{"platform", "kind", "count"}`` for a GPU backend; raises
    :class:`NoGPUError` for anything else (no CPU fallback)."""
    if backend != "gpu":
        raise NoGPUError(f"JAX default backend is {backend!r}, not 'gpu'")
    bad = [d for d in devices if d.platform != "gpu"]
    if not devices or bad:
        raise NoGPUError(f"not all JAX devices are CUDA GPUs: {devices}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def require_gpu() -> dict:
    """:func:`device_info` for the running JAX process."""
    import jax

    return device_info(jax.default_backend(), jax.devices())


def parse_nvidia_smi(text: str) -> list:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> ``[(name, power_limit), ...]``, one per card, as printed
    (``power_limit`` keeps its unit, e.g. ``"700.00 W"``)."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError("nvidia-smi printed no card")
    return cards


def card_line() -> str:
    """The first card's ``nvidia-smi`` line, verbatim (name, power
    limit); every reported number is printed beside it."""
    out = subprocess.run(NVIDIA_SMI_QUERY, check=True, capture_output=True,
                         text=True, timeout=60).stdout
    parse_nvidia_smi(out)
    return out.strip().splitlines()[0].strip()
