"""Batched LTE turbo codec in PyTorch (encoder + max-log-MAP decoder).

Port of dectnrp_tpu/phy/fec/turbo_jax.py (reference: srsRAN turbo used by
lib/src/phy/fec/pdc_enc.cpp / pcc_enc.cpp). Codeblocks are the leading batch
dimension; all index maps (QPP interleaver, tail layout) are static per K.

Decoder engines, chosen by K exactly as `turbo_jax._resolve_bcjr` does:
  * K >= 512: sliding-window max-log-MAP (Lw=128, D=32) in the column-major
    [K+3, B] layout of the CUDA kernel (`bcjr_cuda.bcjr_posterior_cm`: the
    kernel on the card, its plain twin on CPU);
  * K < 512 (the PCC, K = 56 / 96): the unwindowed BCJR below, plain torch.

LLR convention: L = log P(b=1)/P(b=0); positive means bit 1.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..plan import device_tables
from .bcjr_cuda import (NEG, bcjr_posterior_cm, bcjr_windowed_cm_plain,
                        trellis_tables)
from .qpp import deinterleaver, interleaver

# ---------------------------------------------------------------- trellis LUTs
# state s = (r1<<2)|(r2<<1)|r3 holding past feedback values of the RSC
# a = c ^ r2 ^ r3 ; z = a ^ r1 ^ r3 ; next = (a<<2)|(r1<<1)|r2


def _build_trellis():
    """(NEXT, OUT_Z, PRED_S, PRED_C), each [8, 2] int32 (copy of the JAX builder)."""
    nxt = np.zeros((8, 2), dtype=np.int32)
    out = np.zeros((8, 2), dtype=np.int32)
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for c in (0, 1):
            a = c ^ r2 ^ r3
            z = a ^ r1 ^ r3
            nxt[s, c] = (a << 2) | (r1 << 1) | r2
            out[s, c] = z
    pred_s = np.zeros((8, 2), dtype=np.int32)
    pred_c = np.zeros((8, 2), dtype=np.int32)
    cnt = np.zeros(8, dtype=np.int32)
    for s in range(8):
        for c in (0, 1):
            ns = nxt[s, c]
            pred_s[ns, cnt[ns]] = s
            pred_c[ns, cnt[ns]] = c
            cnt[ns] += 1
    assert np.all(cnt == 2)
    return nxt, out, pred_s, pred_c


NEXT, OUT_Z, PRED_S, PRED_C = _build_trellis()


# ------------------------------------------------------------------- encoder

@lru_cache(maxsize=None)
def _rsc_linear_luts(K: int, n: int = 512):
    """Blocked GF(2) state-space form of the RSC (copy of the JAX builder).

    s_out = An s_in + Mc c_block, z_block = G^T s_in + H c_block over blocks
    of n inputs. Returns (nb, H [n,n], G [3,n], Mc [n,3], An [3,3],
    tail_lut [8,6]).
    """
    n = max(d for d in range(1, min(n, K) + 1) if K % d == 0)
    nb = K // n

    def step_many(s, bits):
        zs = np.empty(len(bits), np.int64)
        for i, ck in enumerate(bits):
            zs[i] = OUT_Z[s, ck]
            s = NEXT[s, ck]
        return s, zs

    _, h = step_many(0, np.concatenate([[1], np.zeros(n - 1, np.int64)]))
    idx = np.arange(n)
    H = np.where(idx[:, None] >= idx[None, :], h[(idx[:, None] - idx[None, :])], 0)
    G = np.empty((3, n), np.int64)
    for b in range(3):
        _, G[b] = step_many(1 << (2 - b), np.zeros(n, np.int64))

    def sbits(s):
        return np.array([(s >> 2) & 1, (s >> 1) & 1, s & 1], np.int64)
    An = np.stack([sbits(step_many(1 << (2 - b), np.zeros(n, np.int64))[0])
                   for b in range(3)], axis=1)
    Mc = np.stack([sbits(step_many(0, np.eye(n, dtype=np.int64)[k])[0])
                   for k in range(n)], axis=0)
    tail = np.empty((8, 6), np.int64)
    for s in range(8):
        st = s
        for t in range(3):
            r1, r2, r3 = (st >> 2) & 1, (st >> 1) & 1, st & 1
            ck = r2 ^ r3
            tail[s, t] = ck
            tail[s, 3 + t] = 0 ^ r1 ^ r3
            st = (r1 << 1) | r2
    return nb, H.astype(np.float32), G.astype(np.float32), \
        Mc.astype(np.float32), An.astype(np.int32), tail.astype(np.int32)


def _rsc_encode_linear(bits: torch.Tensor, K: int):
    """RSC via blocked GF(2) matmuls: bits [B,K] -> (z [B,K], xt, zt [B,3]).

    The float32 matmuls are exact (0/1 operands, sums < 2^24) only with TF32
    off, which the package sets on import.
    """
    nb, H, G, Mc, An, tail = device_tables(_rsc_linear_luts, (K,), bits.device)
    n = K // nb
    B = bits.shape[0]
    cb = bits.reshape(B, nb, n).to(torch.float32)
    contrib = torch.remainder(torch.einsum("bmn,nj->bmj", cb, Mc), 2.0)
    AnT = An.T.to(torch.float32)
    s = torch.zeros((B, 3), dtype=torch.float32, device=bits.device)
    s_in = []
    for m in range(nb):                   # nb = K / (largest divisor <= 512)
        s_in.append(s)
        s = torch.remainder(s @ AnT + contrib[:, m], 2.0)
    s_in = torch.stack(s_in, 1)                                    # [B,nb,3]
    z = torch.einsum("bmn,kn->bmk", cb, H) + torch.einsum("bmj,jk->bmk", s_in, G)
    z = torch.remainder(z, 2.0).to(torch.int64).reshape(B, K)
    s = s.to(torch.int64)
    s_id = (s[:, 0] << 2) | (s[:, 1] << 1) | s[:, 2]
    t = tail[s_id]                                                 # [B,6]
    return z, t[:, :3], t[:, 3:]


def turbo_encode(c: torch.Tensor, K: int) -> torch.Tensor:
    """Encode bits [B, K] (uint8) -> d streams uint8 [B, 3, K+4].

    Tail-bit layout of 36.212 5.1.3.2.2 (as turbo_jax._pack_d).
    """
    pi = device_tables(interleaver, (K,), c.device)
    z1, xt1, zt1 = _rsc_encode_linear(c, K)
    z2, xt2, zt2 = _rsc_encode_linear(c[:, pi], K)
    B = c.shape[0]
    d = torch.zeros((B, 3, K + 4), dtype=torch.uint8, device=c.device)
    d[:, 0, :K] = c.to(torch.uint8)
    d[:, 1, :K] = z1.to(torch.uint8)
    d[:, 2, :K] = z2.to(torch.uint8)
    d[:, 0, K:] = torch.stack([xt1[:, 0], zt1[:, 1], xt2[:, 0], zt2[:, 1]], 1).to(torch.uint8)
    d[:, 1, K:] = torch.stack([zt1[:, 0], xt1[:, 2], zt2[:, 0], xt2[:, 2]], 1).to(torch.uint8)
    d[:, 2, K:] = torch.stack([xt1[:, 1], zt1[:, 2], xt2[:, 1], zt2[:, 2]], 1).to(torch.uint8)
    return d


# -------------------------------------------------------------------- decoder

def _bcjr_posterior(Ls, Lp, La, K):
    """Unwindowed max-log-MAP posterior for one constituent code.

    Ls, Lp: [B, K+3] channel LLRs incl. termination steps; La: [B, K]
    a-priori. Returns posterior LLR [B, K] (turbo_jax._bcjr_posterior).
    Plain torch: the PCC (K < 512) runs here on every device.
    """
    tb = device_tables(trellis_tables, (), Ls.device)
    nxt, pred_s, pred_c = tb["nxt"], tb["pred_s"], tb["pred_c"]
    sgn_c, sgn_z = tb["sgn_c"], tb["sgn_z"]
    B, Kt = Ls.shape
    Lsys = Ls + torch.nn.functional.pad(La, (0, 3))
    gamma = 0.5 * (Lsys[:, :, None, None] * sgn_c
                   + Lp[:, :, None, None] * sgn_z)                # [B,Kt,8,2]
    g_pred = gamma[:, :, pred_s, pred_c]                          # [B,Kt,8,2]

    init = torch.full((B, 8), NEG, dtype=Ls.dtype, device=Ls.device)
    init[:, 0] = 0.0
    alphas = []
    a = init
    for k in range(Kt):
        alphas.append(a)
        anew = (a[:, pred_s] + g_pred[:, k]).amax(-1)
        a = anew - anew.amax(-1, keepdim=True)
    betas = [None] * Kt                   # betas[k] = beta_{k+1}
    b = init
    for k in range(Kt - 1, -1, -1):
        betas[k] = b
        bnew = (b[:, nxt] + gamma[:, k]).amax(-1)
        b = bnew - bnew.amax(-1, keepdim=True)
    a_k = torch.stack(alphas[:K], 1)                              # [B,K,8]
    b_k1 = torch.stack(betas[:K], 1)                              # [B,K,8]
    metric = a_k[:, :, :, None] + gamma[:, :K] + b_k1[:, :, nxt]
    return metric[..., 1].amax(-1) - metric[..., 0].amax(-1)


def _bcjr_posterior_windowed(Ls, Lp, La, K, Lw=128, D=32):
    """Parallel-window max-log-MAP, row-major interface of
    turbo_jax._bcjr_posterior_windowed: Ls, Lp [B, K+3], La [B, K] ->
    posterior [B, K]. Runs the kernel's plain twin (bcjr_cuda)."""
    Lsys = Ls + torch.nn.functional.pad(La, (0, 3))
    post = bcjr_windowed_cm_plain(Lsys.T.contiguous(), Lp.T.contiguous(),
                                  K, Lw, D)
    return post.T


@lru_cache(maxsize=None)
def _tail_maps(K: int):
    """Static index maps extracting per-decoder tail LLRs from flat d [3,K+4]."""
    def idx(stream, pos):
        return stream * (K + 4) + pos
    sys1 = [idx(0, K), idx(2, K), idx(1, K + 1)]
    par1 = [idx(1, K), idx(0, K + 1), idx(2, K + 1)]
    sys2 = [idx(0, K + 2), idx(2, K + 2), idx(1, K + 3)]
    par2 = [idx(1, K + 2), idx(0, K + 3), idx(2, K + 3)]
    return (np.array(sys1, np.int32), np.array(par1, np.int32),
            np.array(sys2, np.int32), np.array(par2, np.int32))


def _qpp_tables(K: int):
    return interleaver(K), deinterleaver(K), *_tail_maps(K)


def _llr_streams(d_llr: torch.Tensor, K: int):
    """Split flat d-LLRs into per-constituent (Ls1, Lp1, Ls2, Lp2) [B, K+3]."""
    pi, _, s1, p1, s2, p2 = device_tables(_qpp_tables, (K,), d_llr.device)
    flat = d_llr.reshape(d_llr.shape[0], -1)
    Ls1 = torch.cat([d_llr[:, 0, :K], flat[:, s1]], 1)
    Lp1 = torch.cat([d_llr[:, 1, :K], flat[:, p1]], 1)
    Ls2 = torch.cat([d_llr[:, 0, :K][:, pi], flat[:, s2]], 1)
    Lp2 = torch.cat([d_llr[:, 2, :K], flat[:, p2]], 1)
    return Ls1, Lp1, Ls2, Lp2


def _make_iter(d_llr: torch.Tensor, K: int):
    """Build (one_iter(La1) -> (La1_next, Lpost_deinterleaved), La1_0, kind).

    K >= 512 runs column-major ([K(+3), B], the kernel's layout) through
    `bcjr_posterior_cm`; K < 512 runs row-major [B, K] through the
    unwindowed BCJR, as turbo_jax._make_iter's "cm" / "rm" kinds.
    """
    pi, inv = device_tables(_qpp_tables, (K,), d_llr.device)[:2]
    Ls1, Lp1, Ls2, Lp2 = _llr_streams(d_llr, K)

    if K < 512:
        def one_iter(La1):
            Lpost1 = _bcjr_posterior(Ls1, Lp1, La1, K)
            Le1 = Lpost1 - Ls1[:, :K] - La1
            La2 = Le1[:, pi]
            Lpost2 = _bcjr_posterior(Ls2, Lp2, La2, K)
            Le2 = Lpost2 - Ls2[:, :K] - La2
            return Le2[:, inv], Lpost2[:, inv]

        return one_iter, torch.zeros_like(d_llr[:, 0, :K]), "rm"

    Ls1c, Lp1c = Ls1.T.float().contiguous(), Lp1.T.float().contiguous()
    Ls2c, Lp2c = Ls2.T.float().contiguous(), Lp2.T.float().contiguous()

    def pad3(x):
        return torch.nn.functional.pad(x, (0, 0, 0, 3))

    def one_iter(La1):                                   # La1 [K, B]
        Lpost1 = bcjr_posterior_cm(Ls1c + pad3(La1), Lp1c, K)
        Le1 = Lpost1 - Ls1c[:K] - La1
        La2 = Le1[pi]
        Lpost2 = bcjr_posterior_cm(Ls2c + pad3(La2), Lp2c, K)
        Le2 = Lpost2 - Ls2c[:K] - La2
        return Le2[inv], Lpost2[inv]

    La0 = torch.zeros((K, d_llr.shape[0]), dtype=torch.float32,
                      device=d_llr.device)
    return one_iter, La0, "cm"


def turbo_decode(d_llr: torch.Tensor, K: int, n_iter: int = 8):
    """Decode LLRs [B, 3, K+4] -> (hard bits uint8 [B, K], posterior [B, K])."""
    one_iter, La1, kind = _make_iter(d_llr, K)
    Lpost = None
    for _ in range(n_iter):
        La1, Lpost = one_iter(La1)
    if kind == "cm":
        Lpost = Lpost.T.to(d_llr.dtype)
    return (Lpost > 0).to(torch.uint8), Lpost


def turbo_decode_early(d_llr: torch.Tensor, crc_m: torch.Tensor, K: int,
                       n_iter_max: int = 8, n_iter_min: int = 1):
    """CRC-gated early-stopping decode (reference pdc_enc.cpp:367-401).

    Runs n_iter_min iterations with no CRC check, then iterates while some
    row's CRC (bits = payload||crc, syndrome via one GF(2) matmul with
    crc_m [K-L, L] float32) fails and fewer than n_iter_max iterations ran.
    Converged rows freeze their posterior and a-priori. The loop condition
    is read on the host once per iteration (turbo_jax's lax.while_loop).

    Returns (hard bits [B, K], posterior [B, K], crc_ok [B], n_it int).
    """
    one_iter, La1, kind = _make_iter(d_llr, K)
    Lc = crc_m.shape[1]
    crc_mf = crc_m.to(torch.float32)
    if kind == "cm":
        def crc_ok(Lpost):                                 # Lpost [K, B]
            bits = (Lpost > 0).to(torch.float32)
            syn = torch.remainder(crc_mf.T @ bits[:K - Lc], 2.0)
            return (syn == bits[K - Lc:]).all(0)

        def freeze(keep, old, new):
            return torch.where(keep[None, :], old, new)
    else:
        def crc_ok(Lpost):                                 # Lpost [B, K]
            bits = (Lpost > 0).to(torch.float32)
            syn = torch.remainder(bits[:, :K - Lc] @ crc_mf, 2.0)
            return (syn == bits[:, K - Lc:]).all(1)

        def freeze(keep, old, new):
            return torch.where(keep[:, None], old, new)

    n_it = max(1, n_iter_min)
    for _ in range(n_it):
        La1, Lpost = one_iter(La1)
    ok = crc_ok(Lpost)
    while n_it < n_iter_max and not bool(ok.all()):
        La1_n, Lpost_n = one_iter(La1)
        Lpost = freeze(ok, Lpost, Lpost_n)
        La1 = freeze(ok, La1, La1_n)
        ok = ok | crc_ok(Lpost)
        n_it += 1
    if kind == "cm":
        Lpost = Lpost.T.to(d_llr.dtype)
    return (Lpost > 0).to(torch.uint8), Lpost, ok, n_it
