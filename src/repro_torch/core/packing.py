"""Weight packing: 8 uint4 codes per int32 word, ``[K // 8, N]``.

Nibble ``j`` of word ``w`` holds row ``w * 8 + j`` (little-endian
nibbles), the layout the reference package and its TPU kernel use, so
packed words are bit-identical across the two. torch's uint32 support is
thin (above all on CUDA), so the port never uses it: words are built in
int64 and wrapped to int32 explicitly, and unpacking shifts the int32
word arithmetically and masks with ``& 0xF``, which is exact for
negative words too (the mask drops the sign extension).

Scales and zeros stay as ``[K // GS, N]`` tensors beside the words.
`awq_macro_bytes` / `parse_awq_macro_bytes` write and read the paper's
byte-exact AWQ_MACRO layout (the reference's bytes, built with numpy
reshapes instead of a loop over macros); `packed_linear_nbytes` gives
its size from the shapes alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantize import QuantConfig

PACK = 8  # int4 values per int32 word


def _shifts(device) -> torch.Tensor:
    return 4 * torch.arange(PACK, dtype=torch.int64, device=device)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack uint4-coded ``[K, N]`` integers → ``[K // 8, N] int32``."""
    k, n = q.shape
    if k % PACK != 0:
        raise ValueError(f"K={k} not divisible by {PACK}")
    qq = q.to(torch.int64).reshape(k // PACK, PACK, n)
    word = (qq << _shifts(q.device)[None, :, None]).sum(dim=1)  # [0, 2^32)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    return word.to(torch.int32)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4` → ``[K, N] int32`` in [0, 15]."""
    kp, n = packed.shape
    shifts = _shifts(packed.device).to(torch.int32)[None, :, None]
    nib = (packed[:, None, :] >> shifts) & 0xF
    return nib.reshape(kp * PACK, n)


@dataclasses.dataclass
class PackedLinear:
    """A quantized linear layer's tensors.

    Attributes:
      qweight:     [K//8, N] int32 — packed uint4 codes.
      scales:      [K//GS, N] float32 — per-(group, out-chan) scale.
      zeros:       [K//GS, N] int8 — asymmetric zero-points (uint4 codes).
      input_scale: [K] float32 — AWQ inverse activation scale (ones for RTN).
      bias:        [N] or None.
      group_size:  rows of W per (scale, zero) pair.
      shards:      1, or n for one shard of a linear split n ways over K
                   or N (tensor-parallel serving): the unsharded product
                   is n times this one's, and the hybrid threshold
                   counts that (`qlinear_apply`).
    """

    qweight: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    input_scale: torch.Tensor
    bias: torch.Tensor | None
    group_size: int
    shards: int = 1

    @property
    def k(self) -> int:
        return self.qweight.shape[-2] * PACK

    @property
    def n(self) -> int:
        return self.qweight.shape[-1]

    def to(self, device) -> "PackedLinear":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("qweight", "scales", "zeros", "input_scale")},
            bias=None if self.bias is None else self.bias.to(device))


def pack_linear(q: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
                input_scale: torch.Tensor | None, bias: torch.Tensor | None,
                cfg: QuantConfig) -> PackedLinear:
    k = q.shape[0]
    if input_scale is None:
        input_scale = torch.ones(k, dtype=torch.float32, device=q.device)
    return PackedLinear(
        qweight=pack_int4(q),
        scales=scales.to(torch.float32),
        zeros=zeros.to(torch.int8),
        input_scale=input_scale.to(torch.float32),
        bias=bias,
        group_size=cfg.group_size,
    )


def dequantize_int4(qweight: torch.Tensor, scales: torch.Tensor,
                    zeros: torch.Tensor, group_size: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack + dequantize packed words → float ``[K, N]``: f32
    ``(q - zero) * scale``, then rounded to ``dtype``."""
    q = unpack_int4(qweight)
    k, n = q.shape
    qg = q.reshape(k // group_size, group_size, n).to(torch.float32)
    w = (qg - zeros[:, None, :].to(torch.float32)) * \
        scales[:, None, :].to(torch.float32)
    return w.reshape(k, n).to(dtype)


def dequantize_packed(p: PackedLinear,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Materialize the float weight ``[K, N]`` (the generic path)."""
    return dequantize_int4(p.qweight, p.scales, p.zeros, p.group_size, dtype)


# ---------------------------------------------------------------------------
# Byte-exact AWQ_MACRO serialization (paper Fig. 3)
# ---------------------------------------------------------------------------

def awq_macro_nbytes(group_size: int) -> int:
    """Bytes of one AWQ_MACRO covering GS×8 weights: GS*8 nibbles of
    qweights (GS*4 B), 8 fp16 scales (16 B) and a 128-bit zeros strip
    (8 int4 zeros + 96 bits of padding)."""
    return group_size * 4 + 16 + 16


def macro_count(k: int, n: int, group_size: int) -> int:
    """#macros for a [K, N] linear: one per (K-group, 8 output channels)."""
    if k % group_size or n % 8:
        raise ValueError(f"[{k},{n}] not tileable by GS={group_size}x8")
    return (k // group_size) * (n // 8)


def packed_linear_nbytes(k: int, n: int, group_size: int) -> int:
    """Exact serialized size of one quantized linear in AWQ_MACRO format."""
    return macro_count(k, n, group_size) * awq_macro_nbytes(group_size)


def _nibbles_to_bytes(nib: np.ndarray) -> np.ndarray:
    """[..., 2m] codes in [0, 16) → [..., m] bytes, element 2i in the low
    nibble of byte i."""
    return nib[..., 0::2] | (nib[..., 1::2] << 4)


def _bytes_to_nibbles(b: np.ndarray) -> np.ndarray:
    out = np.empty(b.shape[:-1] + (2 * b.shape[-1],), np.uint8)
    out[..., 0::2] = b & 0xF
    out[..., 1::2] = b >> 4
    return out


def awq_macro_bytes(q: np.ndarray, scales: np.ndarray, zeros: np.ndarray,
                    group_size: int) -> bytes:
    """Serialize a whole [K, N] quantized linear into AWQ_MACRO strips.

    Macros run over K-groups, then over 8-channel column blocks; each is
    ``[GS*8 nibbles of q][8 × fp16 scales][8 nibbles of zeros + 96-bit
    pad]``. The q strip is the macro's (GS, 8) tile row-major, two
    nibbles a byte, low nibble first. ``q`` [K, N] and ``zeros``
    [K/GS, N] hold codes in [0, 16).
    """
    k, n = q.shape
    macro_count(k, n, group_size)
    g, nb = k // group_size, n // 8
    tiles = (np.asarray(q).astype(np.uint8)
             .reshape(g, group_size, nb, 8).transpose(0, 2, 1, 3)
             .reshape(g, nb, group_size * 8))
    sc = (np.asarray(scales).astype(np.float16).reshape(g, nb, 8)
          .view(np.uint8))                                    # [g, nb, 16]
    zb = _nibbles_to_bytes(np.asarray(zeros).astype(np.uint8)
                           .reshape(g, nb, 8))                # [g, nb, 4]
    out = np.zeros((g, nb, awq_macro_nbytes(group_size)), np.uint8)
    qn = group_size * 4
    out[..., :qn] = _nibbles_to_bytes(tiles)
    out[..., qn:qn + 16] = sc
    out[..., qn + 16:qn + 20] = zb
    return out.tobytes()


def parse_awq_macro_bytes(buf: bytes, k: int, n: int, group_size: int):
    """Inverse of `awq_macro_bytes` → (q [K, N] uint8, scales [K/GS, N]
    float16, zeros [K/GS, N] uint8)."""
    g, nb = k // group_size, n // 8
    mb = awq_macro_nbytes(group_size)
    if len(buf) != g * nb * mb:
        raise ValueError(f"{len(buf)} bytes, want {g * nb * mb} for "
                         f"[{k},{n}] at GS={group_size}")
    m = np.frombuffer(buf, np.uint8).reshape(g, nb, mb)
    qn = group_size * 4
    q = (_bytes_to_nibbles(m[..., :qn]).reshape(g, nb, group_size, 8)
         .transpose(0, 2, 1, 3).reshape(k, n))
    scales = (np.ascontiguousarray(m[..., qn:qn + 16]).view(np.float16)
              .reshape(g, n))
    zeros = _bytes_to_nibbles(m[..., qn + 16:qn + 20]).reshape(g, n)
    return q, scales, zeros


def packed_linear_macro_bytes(p: PackedLinear) -> bytes:
    """A `PackedLinear`'s AWQ_MACRO bytes (its words unpacked on the host);
    stacked experts give each expert's linear in turn."""
    n = p.qweight.shape[-1]
    qw = p.qweight.cpu().reshape(-1, p.qweight.shape[-2], n)
    sc = p.scales.cpu().reshape(qw.shape[0], -1, n).numpy()
    zr = p.zeros.cpu().reshape(qw.shape[0], -1, n).numpy()
    return b"".join(awq_macro_bytes(unpack_int4(q).numpy(), s, z,
                                    p.group_size)
                    for q, s, z in zip(qw, sc, zr))
