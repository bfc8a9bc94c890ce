"""Batched SHA-512 as plain PyTorch (the plain version of the SHA-512
kernel, csrc/sha512.cu; counterpart of the JAX package's ops/sha2.py
`sha512` and `_pad_message`).

A 64-bit word is a (hi, lo) pair of int64 tensors holding 32-bit halves,
so every add, shift and rotate is exact without relying on wrapping
integer overflow. Padding is materialised per lane (the kernel pads in
registers instead), and blocks past a lane's own count are masked.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

H512 = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

K512 = (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
)


def _add(*xs):
    hi, lo = xs[0]
    for h, l in xs[1:]:
        lo = lo + l
        hi = hi + h + (lo >> 32)
        lo = lo & _M32
    return hi & _M32, lo


def _rotr(x, n: int):
    hi, lo = x
    if n >= 32:
        hi, lo, n = lo, hi, n - 32
    if n == 0:
        return hi, lo
    return (((hi >> n) | (lo << (32 - n))) & _M32,
            ((lo >> n) | (hi << (32 - n))) & _M32)


def _shr(x, n: int):
    hi, lo = x
    return hi >> n, ((lo >> n) | (hi << (32 - n))) & _M32


def _xor(*xs):
    hi, lo = xs[0]
    for h, l in xs[1:]:
        hi, lo = hi ^ h, lo ^ l
    return hi, lo


def nblocks(msg_len):
    """Blocks a message of msg_len bytes pads to: the 0x80 byte and the
    16-byte big-endian bit length must fit after it."""
    return (msg_len + 17 + 127) // 128


def _pad_message(msg: torch.Tensor, msg_len: torch.Tensor, nblock: int):
    """(B, L) uint8, (B,) lengths -> ((B, nblock*128) padded bytes,
    (B,) per-lane block counts). Bytes past each length are zeroed."""
    total = nblock * 128
    ml = msg_len.to(torch.int64).unsqueeze(-1)
    buf = torch.zeros(msg.shape[:-1] + (total,), dtype=torch.int64,
                      device=msg.device)
    buf[..., :msg.shape[-1]] = msg.to(torch.int64)
    pos = torch.arange(total, device=msg.device)
    buf = torch.where(pos < ml, buf, 0)
    buf = torch.where(pos == ml, 0x80, buf)
    nb = nblocks(msg_len.to(torch.int64))
    end = nb.unsqueeze(-1) * 128            # one past the last byte
    sh = (end - 1 - pos) * 8                # big-endian bit length
    lb = torch.where((sh >= 0) & (sh < 64),
                     ((ml * 8) >> sh.clamp(0, 63)) & 0xFF, 0)
    buf = torch.where((pos >= end - 16) & (pos < end), lb, buf)
    return buf, nb


def sha512(msg: torch.Tensor, msg_len: torch.Tensor) -> torch.Tensor:
    """msg (B, L) uint8, msg_len (B,) int32 (each <= L) -> (B, 64) uint8
    digests of msg[i, :msg_len[i]]."""
    nblock = int(nblocks(msg.shape[-1]))
    buf, nb = _pad_message(msg, msg_len, nblock)
    w8 = buf.reshape(buf.shape[:-1] + (nblock, 16, 8))
    whi = (w8[..., 0] << 24) | (w8[..., 1] << 16) | (w8[..., 2] << 8) \
        | w8[..., 3]
    wlo = (w8[..., 4] << 24) | (w8[..., 5] << 16) | (w8[..., 6] << 8) \
        | w8[..., 7]
    z = torch.zeros(msg.shape[:-1], dtype=torch.int64, device=msg.device)
    state = [(z + (h >> 32), z + (h & _M32)) for h in H512]
    for blk in range(nblock):
        w = [(whi[..., blk, t], wlo[..., blk, t]) for t in range(16)]
        for t in range(16, 80):
            s0 = _xor(_rotr(w[t - 15], 1), _rotr(w[t - 15], 8),
                      _shr(w[t - 15], 7))
            s1 = _xor(_rotr(w[t - 2], 19), _rotr(w[t - 2], 61),
                      _shr(w[t - 2], 6))
            w.append(_add(w[t - 16], s0, w[t - 7], s1))
        a, b, c, d, e, f, g, h = state
        for t in range(80):
            s1 = _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
            ch = ((e[0] & f[0]) ^ (~e[0] & g[0] & _M32),
                  (e[1] & f[1]) ^ (~e[1] & g[1] & _M32))
            k = (K512[t] >> 32, K512[t] & _M32)
            t1 = _add(h, s1, ch, (z + k[0], z + k[1]), w[t])
            s0 = _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
            maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
                   (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
            a, b, c, d, e, f, g, h = (_add(t1, s0, maj), a, b, c,
                                      _add(d, t1), e, f, g)
        act = blk < nb
        state = [(torch.where(act, n[0], o[0]), torch.where(act, n[1], o[1]))
                 for n, o in zip((_add(s, v) for s, v in zip(
                     state, (a, b, c, d, e, f, g, h))), state)]
    out = []
    for hi, lo in state:
        for word in (hi, lo):
            for sh in (24, 16, 8, 0):
                out.append((word >> sh) & 0xFF)
    return torch.stack(out, dim=-1).to(torch.uint8)
