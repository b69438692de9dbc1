"""PCC / PDC FEC chains (port of dectnrp_tpu/phy/fec/chain.py).

Mirrors reference lib/src/phy/fec/{pcc_enc,pdc_enc,fec}.cpp:
- PCC: PLCF (40/80 bit) + CRC16 masked by closed-loop/beamforming flags
  (0x0000/0x5555/0xAAAA/0xFFFF), turbo, rate match to 196 bits, scramble with
  g_init 0x44454354. RX blind-decodes both PLCF types.
- PDC: TB + CRC24A, codeblock segmentation (C2 small blocks FIRST, matching
  pdc_enc.cpp:164-169), per-CB CRC24B when C>1, turbo, per-CB rate matching
  with rv support, network-id scrambling.

The numpy LUT builders are copies of the JAX module's; their tensors come
from `plan.device_tables`, once per device. Device work is gathers, XORs,
GF(2) float32 matmuls (exact: TF32 is off) and the batched turbo codec.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ...common.trace import count
from ...sections.part3.cbsegm import CbSegm, cbsegm
from ...sections.part3.scrambling import PCC_G_INIT, lte_pr_sequence, pdc_g_init
from ..plan import device_tables
from .crc import POLY_CRC16, POLY_CRC24A, POLY_CRC24B, crc_matrix
from .rate_match import cb_e_sizes, sel_indices
from .turbo import turbo_decode, turbo_decode_early, turbo_encode


def _crc_device(bits: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """GF(2) CRC via matmul: bits [B, K] -> crc uint8 [B, L]; M float32 [K, L]."""
    r = bits.to(torch.float32) @ M
    return torch.remainder(r, 2.0).to(torch.uint8)


# ---------------------------------------------------------------------- PCC

@dataclass(frozen=True)
class PccPlan:
    plcf_type: int          # 1 or 2
    n_plcf_bits: int        # 40 or 80
    K: int                  # turbo block size (56 or 96)

    @staticmethod
    @lru_cache(maxsize=None)
    def get(plcf_type: int) -> "PccPlan":
        n = 40 if plcf_type == 1 else 80
        return PccPlan(plcf_type=plcf_type, n_plcf_bits=n, K=n + 16)


@lru_cache(maxsize=4)
def _pcc_luts(plcf_type: int):
    plan = PccPlan.get(plcf_type)
    sel = sel_indices(plan.K, 196, 0)
    scr = lte_pr_sequence(196, PCC_G_INIT)
    m_crc = crc_matrix(plan.n_plcf_bits, POLY_CRC16)
    return plan, sel, scr, m_crc


def _pcc_tables(plcf_type: int):
    plan, sel, scr, m_crc = _pcc_luts(plcf_type)
    idx = np.arange(16)
    return {"sel": sel, "scr": scr.astype(np.uint8),
            "sgn": (1.0 - 2.0 * scr).astype(np.float32),
            "m_crc": m_crc.astype(np.float32),
            "m_cl": ((0x5555 >> (15 - idx)) & 1).astype(np.uint8),
            "m_bf": ((0xAAAA >> (15 - idx)) & 1).astype(np.uint8),
            "pow2": (2 ** (15 - idx)).astype(np.int64)}


def pcc_encode(a: torch.Tensor, cl: torch.Tensor, bf: torch.Tensor,
               plcf_type: int) -> torch.Tensor:
    """PLCF bits [B, 40/80] + flags [B] -> 196 coded bits uint8 [B, 196]."""
    plan = PccPlan.get(plcf_type)
    tb = device_tables(_pcc_tables, (plcf_type,), a.device)
    crc = _crc_device(a, tb["m_crc"])
    mask = (cl[:, None].to(torch.uint8) * tb["m_cl"]) ^ (
        bf[:, None].to(torch.uint8) * tb["m_bf"])
    c = torch.cat([a.to(torch.uint8), crc ^ mask], 1)
    d = turbo_encode(c, plan.K)                      # [B, 3, K+4]
    e = d.reshape(d.shape[0], -1)[:, tb["sel"]]
    return e ^ tb["scr"]


def pcc_decode(e_llr: torch.Tensor, plcf_type: int, n_iter: int = 8):
    """196 LLRs [B, 196] -> (plcf bits [B, n], crc_ok [B], cl [B], bf [B]).

    crc_ok is True only when the CRC syndrome matches one of the 4 valid masks.
    """
    plan = PccPlan.get(plcf_type)
    tb = device_tables(_pcc_tables, (plcf_type,), e_llr.device)
    llr = e_llr * tb["sgn"].to(e_llr.dtype)
    d = torch.zeros((e_llr.shape[0], 3 * (plan.K + 4)), dtype=e_llr.dtype,
                    device=e_llr.device)
    d.index_add_(1, tb["sel"], llr)
    bits, _ = turbo_decode(d.reshape(-1, 3, plan.K + 4), plan.K, n_iter)
    a, crc_rx = bits[:, :plan.n_plcf_bits], bits[:, plan.n_plcf_bits:]
    syndrome = _crc_device(a, tb["m_crc"]) ^ crc_rx  # [B, 16]
    s16 = (syndrome.to(torch.int64) * tb["pow2"]).sum(1)
    ok = (s16 == 0x0000) | (s16 == 0x5555) | (s16 == 0xAAAA) | (s16 == 0xFFFF)
    cl = (s16 == 0x5555) | (s16 == 0xFFFF)
    bf = (s16 == 0xAAAA) | (s16 == 0xFFFF)
    return a, ok, cl, bf


# ---------------------------------------------------------------------- PDC

@dataclass(frozen=True)
class PdcPlan:
    """Static FEC geometry for one packet configuration."""
    N_TB_bits: int
    G: int
    Qm: int                 # N_bps
    Z: int
    seg: CbSegm
    cb_K: tuple[int, ...]       # per-cb K, processing order (C2 first)
    cb_E: tuple[int, ...]       # per-cb rate-matched size
    cb_rlen: tuple[int, ...]    # per-cb payload bits taken from the TB stream

    @staticmethod
    @lru_cache(maxsize=None)
    def get(N_TB_bits: int, G: int, Qm: int, Z: int) -> "PdcPlan":
        seg = cbsegm(N_TB_bits, Z)
        assert seg.F == 0, "filler bits unsupported (rejected by packet_sizes)"
        cb_K = seg.cb_sizes
        cb_E = tuple(cb_e_sizes(G, Qm, seg.C))
        cb_rlen = tuple(k - 24 if seg.C > 1 else k for k in cb_K)
        return PdcPlan(N_TB_bits=N_TB_bits, G=G, Qm=Qm, Z=Z, seg=seg,
                       cb_K=cb_K, cb_E=cb_E, cb_rlen=cb_rlen)


@lru_cache(maxsize=None)
def _pdc_luts(plan: PdcPlan, network_id: int, plcf_type: int, rv: int):
    scr = lte_pr_sequence(plan.G, pdc_g_init(network_id, plcf_type))
    sels = tuple(sel_indices(K, E, rv) for K, E in zip(plan.cb_K, plan.cb_E))
    m_tb = crc_matrix(plan.N_TB_bits, POLY_CRC24A)
    m_cb = {K: crc_matrix(K - 24, POLY_CRC24B) for K in set(plan.cb_K)} \
        if plan.seg.C > 1 else {}
    return scr, sels, m_tb, m_cb


@lru_cache(maxsize=None)
def _pdc_global_inv(plan: PdcPlan, network_id: int, plcf_type: int, rv: int):
    """Static inverse of _pdc_global_sel: inv[m, j] = m-th e-index feeding
    padded-d position j, padded with the sentinel G (a zero LLR slot the
    caller appends). m_max > 1 only under repetition, where the m gathers
    soft-combine like a scatter-add."""
    gsel, Kp = _pdc_global_sel(plan, network_id, plcf_type, rv)
    Dtot = len(plan.cb_K) * 3 * Kp
    G = gsel.size
    buckets: dict[int, list[int]] = {}
    for e, j in enumerate(gsel):
        buckets.setdefault(int(j), []).append(e)
    m_max = max(len(b) for b in buckets.values())
    inv = np.full((m_max, Dtot), G, np.int32)
    for j, bk in buckets.items():
        for m, e in enumerate(bk):
            inv[m, j] = e
    return inv, Kp


@lru_cache(maxsize=None)
def _pdc_global_sel(plan: PdcPlan, network_id: int, plcf_type: int, rv: int):
    """ONE flat [G] index map over the padded per-cb d-domain [C, 3, Kp],
    Kp = max(K)+4: codeblock i's rate-match selection (stream s, pos p)
    re-linearizes to i*3*Kp + s*Kp + p."""
    Kp = max(plan.cb_K) + 4
    out = []
    for i, (K, sel) in enumerate(zip(plan.cb_K, _pdc_luts(
            plan, network_id, plcf_type, rv)[1])):
        s, p = sel // (K + 4), sel % (K + 4)
        out.append(i * 3 * Kp + s * Kp + p)
    return np.concatenate(out).astype(np.int32), Kp


def _cb_groups(plan: PdcPlan) -> dict[int, list[int]]:
    """Codeblock indices grouped by K (batched turbo decode groups)."""
    by_k: dict[int, list[int]] = {}
    for i, K in enumerate(plan.cb_K):
        by_k.setdefault(K, []).append(i)
    return by_k


def _pdc_tables(plan: PdcPlan, network_id: int, plcf_type: int, rv: int):
    scr, _, _, _ = _pdc_luts(plan, network_id, plcf_type, rv)
    gsel, Kp = _pdc_global_sel(plan, network_id, plcf_type, rv)
    inv, _ = _pdc_global_inv(plan, network_id, plcf_type, rv)
    return {"scr": scr.astype(np.uint8),
            "sgn": (1.0 - 2.0 * scr).astype(np.float32),
            "gsel": gsel, "inv": inv, "Kp": Kp,
            "groups": {K: np.asarray(ix, np.int64)
                       for K, ix in _cb_groups(plan).items()}}


def _pdc_crc_tables(plan: PdcPlan):
    """CRC GF(2) matrices: TB CRC24A, per-K codeblock CRC24B (C > 1) and
    the per-K early-stop check (the CB CRC, or the TB CRC when C == 1)."""
    m_cb = {K: crc_matrix(K - 24, POLY_CRC24B) for K in set(plan.cb_K)} \
        if plan.seg.C > 1 else {}
    m_k = {K: m_cb[K] if plan.seg.C > 1 else crc_matrix(K - 24, POLY_CRC24A)
           for K in set(plan.cb_K)}
    f32 = {K: m.astype(np.float32) for K, m in m_cb.items()}
    return {"m_tb": crc_matrix(plan.N_TB_bits, POLY_CRC24A).astype(np.float32),
            "m_cb": f32, "m_k": {K: m.astype(np.float32) for K, m in m_k.items()}}


def pdc_encode(tb_bits: torch.Tensor, plan: PdcPlan, network_id: int,
               plcf_type: int, rv: int = 0) -> torch.Tensor:
    """TB bits [B, N_TB_bits] -> G coded+scrambled bits uint8 [B, G]."""
    t = device_tables(_pdc_tables, (plan, network_id, plcf_type, rv),
                      tb_bits.device)
    crc_t = device_tables(_pdc_crc_tables, (plan,), tb_bits.device)
    crc_tb = _crc_device(tb_bits, crc_t["m_tb"])
    b_seq = torch.cat([tb_bits.to(torch.uint8), crc_tb], 1)
    blocks, rp = [], 0
    for K, rlen in zip(plan.cb_K, plan.cb_rlen):
        payload = b_seq[:, rp:rp + rlen]
        rp += rlen
        if plan.seg.C > 1:
            payload = torch.cat([payload, _crc_device(payload, crc_t["m_cb"][K])], 1)
        blocks.append(payload)

    B, C, Kp = tb_bits.shape[0], len(plan.cb_K), t["Kp"]
    D = torch.zeros((B, C, 3, Kp), dtype=torch.uint8, device=tb_bits.device)
    for K, idxs in _cb_groups(plan).items():      # one turbo call per K
        enc = turbo_encode(torch.cat([blocks[i] for i in idxs], 0), K)
        for j, i in enumerate(idxs):
            D[:, i, :, :K + 4] = enc[j * B:(j + 1) * B]
    e = D.reshape(B, -1)[:, t["gsel"]]
    return e ^ t["scr"]


def pdc_dematch(e_llr: torch.Tensor, plan: PdcPlan, network_id: int,
                plcf_type: int, rv: int = 0) -> dict[int, torch.Tensor]:
    """G LLRs [B, G] -> d-domain soft bits {K: [nK*B, 3, K+4]} (cb-major rows).

    The d-domain tensors are the HARQ softbuffers: retransmissions with any
    rv de-rate-match into the same positions (static inverse gathers).
    """
    t = device_tables(_pdc_tables, (plan, network_id, plcf_type, rv),
                      e_llr.device)
    llr = e_llr * t["sgn"].to(e_llr.dtype)
    B, C, Kp = e_llr.shape[0], len(plan.cb_K), t["Kp"]
    llr_pad = torch.cat([llr, llr.new_zeros((B, 1))], 1)
    inv = t["inv"]
    D = llr_pad[:, inv[0]]
    for m in range(1, inv.shape[0]):
        D = D + llr_pad[:, inv[m]]
    D = D.reshape(B, C, 3, Kp)
    return {K: D[:, t["groups"][K], :, :K + 4].transpose(0, 1).reshape(-1, 3, K + 4)
            for K in _cb_groups(plan)}


def pdc_decode_d(d_by_k: dict[int, torch.Tensor], plan: PdcPlan,
                 n_iter: int = 8, early_stop: bool = True):
    """Decode from (possibly HARQ-combined) d-domain softbuffers ->
    (tb bits [B, N_TB], tb_ok [B]).

    early_stop: CRC-gated iterations (pdc_enc.cpp:367-401) with
    n_iter_min=2, the reference's SRSRAN_PDSCH_MIN_TDEC_ITERS
    (pdc_enc.cpp:393): never accept a CRC pass from iteration 1. Otherwise
    a fixed n_iter iterations; the CRC checks that follow are the same.
    """
    dev = d_by_k[plan.cb_K[0]].device
    t = device_tables(_pdc_crc_tables, (plan,), dev)
    by_k = _cb_groups(plan)
    B = d_by_k[plan.cb_K[0]].shape[0] // len(by_k[plan.cb_K[0]])
    bits_by_k = {}
    for K in by_k:
        if early_stop:
            bits_by_k[K], _, _, n_it = turbo_decode_early(
                d_by_k[K], t["m_k"][K], K, n_iter_max=n_iter, n_iter_min=2)
        else:
            bits_by_k[K], n_it = turbo_decode(d_by_k[K], K, n_iter)[0], n_iter
        count("fec.pdc_blocks")
        count("fec.pdc_iters", n_it)

    ptr = {K: 0 for K in by_k}
    payloads = []
    cb_ok = torch.ones((B,), dtype=torch.bool, device=dev)
    for K in plan.cb_K:
        j = ptr[K]
        ptr[K] += 1
        bits = bits_by_k[K][j * B:(j + 1) * B]
        if plan.seg.C > 1:
            payload, cbcrc = bits[:, :K - 24], bits[:, K - 24:]
            cb_ok = cb_ok & (_crc_device(payload, t["m_cb"][K]) == cbcrc).all(1)
        else:
            payload = bits
        payloads.append(payload)
    b_seq = torch.cat(payloads, 1)
    tb, crc_rx = b_seq[:, :plan.N_TB_bits], b_seq[:, plan.N_TB_bits:]
    tb_ok = (_crc_device(tb, t["m_tb"]) == crc_rx).all(1) & cb_ok
    return tb, tb_ok


def pdc_decode(e_llr: torch.Tensor, plan: PdcPlan, network_id: int,
               plcf_type: int, rv: int = 0, n_iter: int = 8):
    """G LLRs [B, G] -> (tb bits [B, N_TB_bits], tb_crc_ok [B])."""
    return pdc_decode_d(pdc_dematch(e_llr, plan, network_id, plcf_type, rv),
                        plan, n_iter)
