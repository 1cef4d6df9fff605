"""Dense matmul with the mixed-precision policy — the port of
``paddle_tpu/ops/linear.py`` (with ``cos_sim``).

compute_dtype float32: the product runs in full float32 (TF32 is off,
``paddle_tpu_torch/__init__.py``), the counterpart of the JAX
package's ``precision=HIGHEST``. compute_dtype bfloat16: both inputs
are cast to bf16 and multiplied with float32 accumulation (cuBLAS with
reduced-precision reduction off, also set in ``__init__.py``), and the
product is emitted in bf16 — f32 master weights must not promote the
activations back to f32.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.config import global_config

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype() -> torch.dtype:
    return _DTYPES[global_config().compute_dtype]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    cd = compute_dtype()
    if cd != torch.float32:
        return torch.matmul(a.to(cd), b.to(cd))
    out = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(out), b.to(out))


def cos_sim(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0,
            eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity (paddle/function/CosSimOp,
    CosSimLayer): scale * <a, b> / max(|a| |b|, eps)."""
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
    return scale * num / torch.clamp(den, min=eps)
