"""Flash-attention forward: the CUDA wrapper and its plain PyTorch twin.

Counterpart of ``atomo_tpu/ops/attention_kernels.py``. The Pallas TPU kernel
there (``flash_attention`` -> ``_flash_forward`` -> ``_fa_kernel``) becomes the
hand-written CUDA kernel in ``csrc/flash_attention.cu`` (built for sm_90a by
:mod:`atomo_tpu_torch.ops._build`):

* :func:`flash_attention` is the public function, in the JAX package's
  layout and signature: exact attention (B, H, S, D) -> (B, H, S, D), float32
  or bfloat16 in, float32 accumulation, output in the input type. It is a
  ``torch.autograd.Function``: the forward is :func:`flash_attention_forward`;
  the backward, as in the JAX package (which has no backward kernel),
  recomputes through the port's ``parallel.ring.blockwise_attention`` with
  ``block_size=block_k`` under autograd;
* :func:`flash_attention_forward` launches the kernel on CUDA tensors (or
  raises: there is no fallback to the plain twin, to SDPA or to the
  blockwise oracle) and runs :func:`flash_attention_plain` on CPU tensors.
  It counts its launches in ``flash_attention_forward.launches``, and
  those on bfloat16 inputs in ``flash_attention_forward.bf16_launches``.

The kernel runs both products on the tensor cores (``wgmma``; float32 as
three TF32 products, which keeps float32 accuracy; bfloat16 as one bf16
product) and reads q, k and v through their strides in 16-byte asynchronous
copies, so every base address and (batch, head, row) stride must be a
multiple of 16 bytes: the wrapper refuses other views. It masks a ragged S
itself, so every CUDA call launches it; the JAX package's ``S % block``
fallback to ``blockwise_attention`` gives the same numbers, so the port has
no such branch. The kernel's tiles (64 query rows a warpgroup, 64- or 32-key
tiles) are its own: ``block_q``/``block_k`` shape the plain twin and the
backward only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from atomo_tpu_torch.ops import _build

_LIB = "flash_attention"
_F32_TINY = float(torch.finfo(torch.float32).tiny)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _resolve(q: torch.Tensor, scale: Optional[float], block_q: int, block_k: int):
    s, d = q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return float(scale), min(block_q, s), min(block_k, s)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """The kernel's recurrence in torch ops, tile by tile as ``_fa_kernel``
    walks its grid: per (block_q) query tile, an online-softmax state
    (m, l, acc) in float32 folds the (block_k) key tiles in order, causal
    tiles wholly above the diagonal are skipped, and the result is
    acc / max(l, tiny) in the input type. A ragged last tile is just shorter."""
    scale, bq, bk = _resolve(q, scale, block_q, block_k)
    s = q.shape[2]
    out = torch.empty_like(q)
    for q0 in range(0, s, bq):
        qt = q[:, :, q0 : q0 + bq].float()
        rows = qt.shape[2]
        q_pos = torch.arange(q0, q0 + rows, device=q.device)
        m = torch.full(qt.shape[:3], float("-inf"), device=q.device)
        l = torch.zeros(qt.shape[:3], device=q.device)
        acc = torch.zeros(qt.shape, device=q.device)
        for k0 in range(0, s, bk):
            if causal and k0 > q0 + rows - 1:
                break
            kt = k[:, :, k0 : k0 + bk].float()
            vt = v[:, :, k0 : k0 + bk].float()
            sc = torch.matmul(qt, kt.transpose(-1, -2)) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)
                sc = sc.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(torch.isfinite(sc), torch.exp(sc - m_safe[..., None]), 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vt)
            m = m_new
        out[:, :, q0 : q0 + rows] = (acc / torch.clamp_min(l, _F32_TINY)[..., None]).to(q.dtype)
    return out


# ------------------------------------------------------------- CUDA wrapper


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    if not getattr(lib, "_flash_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_forward.argtypes = [p, p, p, p, i, i, i, i, p, i, i,
                                                ctypes.c_float, p]
        lib.flash_attention_forward.restype = ctypes.c_int
        lib._flash_typed = True
    return lib


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain twin); anything else is refused."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"q, k, v must share one device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no flash-attention kernel for device {dev}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along D")
        # the kernel copies 16-byte chunks of rows asynchronously
        size = t.element_size()
        if t.data_ptr() % 16 or any(st * size % 16 for n, st in zip(t.shape[:3], t.stride()[:3])
                                    if n > 1):
            raise ValueError(f"{name} must start at a 16-byte aligned address with "
                             f"(batch, head, row) strides of whole 16 bytes, got "
                             f"address {t.data_ptr():#x}, strides {t.stride()[:3]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not supported; the kernel takes {HEAD_DIMS}")


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Attention forward: the CUDA kernel on CUDA tensors, the plain twin on
    CPU tensors. No gradient (see :func:`flash_attention`)."""
    if not _on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
    _check(q, k, v)
    scale, _, _ = _resolve(q, scale, block_q, block_k)
    b, h, s, d = q.shape
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(st for t in (q, k, v) for st in t.stride()[:3]))
    rc = _lib().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
        ctypes.cast(strides, ctypes.c_void_p), _DTYPE_CODES[q.dtype], int(causal),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"flash_attention_forward launch failed: CUDA error {rc}")
    flash_attention_forward.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_forward.bf16_launches += 1
    return out


flash_attention_forward.launches = 0
flash_attention_forward.bf16_launches = 0  # of those launches, on bfloat16 inputs


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block_q: int, block_k: int):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, block_k)
        return flash_attention_forward(q, k, v, causal=causal, scale=scale,
                                       block_q=block_q, block_k=block_k)

    @staticmethod
    def backward(ctx, grad_out):
        from atomo_tpu_torch.parallel.ring import blockwise_attention

        causal, scale, block_k = ctx.args
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = blockwise_attention(*inputs, causal=causal, scale=scale,
                                      block_size=block_k)
        grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Fused exact attention (B, H, S, D) -> (B, H, S, D), differentiable:
    the forward is the kernel (its plain twin on CPU tensors), the backward
    the blockwise oracle's, as in ``atomo_tpu.ops.attention_kernels``."""
    scale, bq, bk = _resolve(q, scale, block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, scale, bq, bk)


def launch_counts() -> dict[str, int]:
    return {"flash_attention": flash_attention_forward.launches}


def bf16_launch_count() -> int:
    """The launches counted by :func:`launch_counts` that took bfloat16
    inputs (the LM's ``--bf16``)."""
    return flash_attention_forward.bf16_launches


def reset_launch_counts() -> None:
    flash_attention_forward.launches = 0
    flash_attention_forward.bf16_launches = 0
