"""Virtual space: lock-step superposition of all simulated nodes' TX streams
(port of dectnrp_tpu/simulation/vspace.py; reference
lib/src/simulation/vspace.cpp:159-267).

A tick is one function of device tensors over the stacked [N, A, spp] TX
block: every node's RX is the superposition of all nodes' TX through the
per-edge channel (complete graph: awgn, flat or doubly-selective) and path
loss, its own TX leakage (the i == i edge), and thermal noise. Global time
advances spp samples a tick.

Each tick is a draw and a pure apply (`draw_tick`, `apply_tick`): the draw
takes the space's explicit `torch.Generator` (seeded from `sim_seed`, on
the space's device) and returns the tick's random numbers; `VSpace.tick`
takes them as an optional argument. jax.random's streams cannot be
reproduced in torch, so a parity test hands the JAX package's own draws to
the apply. The flat channel's edge matrices are drawn with numpy from
`sim_seed`, as the JAX module draws them, and so are equal in both.

The mesh-sharded tick (`tick_sharded`) shards the node axis over a device
mesh (common/mesh.py) and realizes the superposition as a reduce-scatter
`psum` over it; its noise is drawn per shard (`draw_tick_sharded`) or
handed in, as for the dense tick.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..common.mesh import Mesh, psum
from .channels import apply_doubly, draw_doubly, draw_noise, tap_table
from .topology import Trajectory, fspl_db


@dataclass
class VNodeConfig:
    n_ant: int = 1
    trajectory: Trajectory = field(default_factory=Trajectory)
    tx_leakage_db: float = float("inf")     # inf = no TX->RX leakage
    noise_figure_db: float = 0.0


@dataclass
class VSpaceConfig:
    samp_rate: float
    spp_len: int
    freq_hz: float = 1.9e9
    channel_inter: str = "awgn"             # awgn | flat | doubly_<pdp>_<tau_ns>_<fd>
    channel_intra: str = "awgn"
    noise_var: float = 0.0                  # per-sample RX noise variance
    sim_seed: int = 0


#: the Jakes sinusoids a doubly-selective tap sums (channels.doubly_selective)
N_SIN = 8


def noise_var_from_snr_net_bw(snr_db: float, net_bandwidth_norm: float) -> float:
    """reference noise.cpp: n0_dB = -10 log10(net_bw_norm) - snr (signal = 1)."""
    n0_db = -10.0 * np.log10(net_bandwidth_norm) - snr_db
    return float(10.0 ** (n0_db / 10.0))


def _parse_doubly(name: str):
    _, pdp, tau, fd = name.split("_")
    return int(pdp), float(tau) * 1e-9, float(fd)


def doubly_taps(channel_inter: str, samp_rate: float) -> int:
    """Live taps L of a doubly-selective edge channel at samp_rate."""
    pdp, tau, _ = _parse_doubly(channel_inter)
    return tap_table(samp_rate, tau, pdp)[0].size


def draw_tick(generator: torch.Generator, N: int, A: int, S: int,
              channel_inter: str, samp_rate: float, noise_var: float,
              device) -> dict:
    """One tick's random numbers: "noise" complex64 [N, A, S] of unit
    variance (if noise_var > 0) and, for a doubly-selective channel, each
    directed edge's Jakes angles and phases "theta" / "phi" float32
    [N (rx i), N (tx j), A, A, L, N_SIN]."""
    out = {}
    if channel_inter.startswith("doubly"):
        L = doubly_taps(channel_inter, samp_rate)
        th, ph = draw_doubly(generator, N * N, A, A, L, N_SIN, device)
        out["theta"] = th.reshape(N, N, A, A, L, N_SIN)
        out["phi"] = ph.reshape(N, N, A, A, L, N_SIN)
    if noise_var > 0.0:
        out["noise"] = draw_noise(generator, (N, A, S), device)
    return out


def apply_tick(tx: torch.Tensor, gain: torch.Tensor, edge_H, draws: dict,
               channel_inter: str, samp_rate: float,
               noise_var: float) -> torch.Tensor:
    """tx complex64 [N, A, S], gain float32 [N, N] (gain[j, i]: tx j -> rx i)
    -> rx complex64 [N, A, S] (dectnrp_tpu/simulation/vspace.py:126)."""
    N, A, S = tx.shape
    g = gain.to(torch.complex64)
    if channel_inter == "awgn" or edge_H is None and not \
            channel_inter.startswith("doubly"):
        # rx_i = sum_j gain[j, i] * tx_j  (identity antenna mapping)
        rx = torch.einsum("ji,jas->ias", g, tx)
    elif channel_inter == "flat":
        rx = torch.einsum("ji,jiab,jbs->ias", g, edge_H, tx)
    else:
        pdp, tau, fd = _parse_doubly(channel_inter)
        # every directed edge (i, j) as one batch row: tx_j through its own
        # draws into rx_i's antennas
        x = tx[None].expand(N, N, A, S).reshape(N * N, A, S)
        y = apply_doubly(x, draws["theta"].reshape(N * N, A, A, -1, N_SIN),
                         draws["phi"].reshape(N * N, A, A, -1, N_SIN),
                         samp_rate, tau_rms_s=tau, doppler_hz=fd, pdp_idx=pdp)
        rx = torch.einsum("ji,ijas->ias", g, y.reshape(N, N, A, S))
    if noise_var > 0.0:
        rx = rx + noise_var ** 0.5 * draws["noise"]
    return rx


class VSpace:
    """N-node virtual ether on `device`; call tick(tx_spps) per spp period."""

    def __init__(self, cfg: VSpaceConfig, nodes: list[VNodeConfig],
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.nodes = nodes
        self.N = len(nodes)
        self.A = max(n.n_ant for n in nodes)
        self.now = 0                 # global sample counter
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.sim_seed)
        self._edge_H = None          # static flat-fading edge matrices

        if cfg.channel_inter == "flat":
            r = np.random.default_rng(cfg.sim_seed ^ 0xF1A7)
            Hs = (r.standard_normal((self.N, self.N, self.A, self.A))
                  + 1j * r.standard_normal((self.N, self.N, self.A, self.A)))
            Hs = (Hs / np.sqrt(2.0)).astype(np.complex64)
            # reciprocity: H_ij = H_ji^T (reference link_t primary/secondary)
            iu = np.triu_indices(self.N, 1)
            Hs[iu[1], iu[0]] = np.swapaxes(Hs[iu[0], iu[1]], -1, -2)
            self._edge_H = torch.from_numpy(Hs).to(self.device)

        # pathloss amplitude gains per directed edge, updated per tick
        self._gain = np.ones((self.N, self.N), np.float32)
        self._gain_sent = None       # the gains on the device (moved on change)
        self._gain_dev = None

    def _update_gains(self) -> None:
        t_s = self.now / self.cfg.samp_rate
        pos = [n.trajectory.position_at(t_s) for n in self.nodes]
        for i in range(self.N):
            for j in range(self.N):
                if i == j:
                    leak = self.nodes[i].tx_leakage_db
                    self._gain[i, j] = 0.0 if np.isinf(leak) \
                        else 10.0 ** (-leak / 20.0)
                else:
                    pl = fspl_db(pos[i].distance(pos[j]), self.cfg.freq_hz)
                    self._gain[i, j] = 10.0 ** (-pl / 20.0)

    def draw(self) -> dict:
        """This tick's draws from the space's generator (draw_tick)."""
        c = self.cfg
        return draw_tick(self.generator, self.N, self.A, c.spp_len,
                         c.channel_inter, c.samp_rate, c.noise_var, self.device)

    def tick(self, tx_spps: torch.Tensor, draws: dict | None = None) -> torch.Tensor:
        """tx_spps complex64 [N, A, spp] on the space's device -> rx_spps
        [N, A, spp] there; advances global time. `draws` (draw_tick's dict)
        replaces the generator's draws for this tick."""
        assert tuple(tx_spps.shape) == (self.N, self.A, self.cfg.spp_len)
        self._update_gains()
        if draws is None:
            draws = self.draw()
        if self._gain_dev is None or not np.array_equal(self._gain, self._gain_sent):
            self._gain_sent = self._gain.copy()
            self._gain_dev = torch.from_numpy(self._gain_sent).to(self.device)
        rx = apply_tick(tx_spps, self._gain_dev, self._edge_H, draws,
                        self.cfg.channel_inter, self.cfg.samp_rate,
                        self.cfg.noise_var)
        self.now += self.cfg.spp_len
        return rx


def _node_shards(mesh: Mesh, N: int):
    """The devices along the mesh's "node" axis (index 0 on the others) and
    the nodes a shard holds."""
    devs = mesh.devices_along("node", (0,) * (len(mesh.axis_names) - 1))
    if N % len(devs):
        raise ValueError(f"tick_sharded: {N} nodes over {len(devs)} shards")
    return devs, N // len(devs)


def draw_tick_sharded(generator: torch.Generator, mesh: Mesh, N: int, A: int,
                      spp: int) -> list[torch.Tensor]:
    """The sharded tick's noise: one unit-variance complex64 block
    [N / n_shards, A, spp] a shard, drawn on the generator's device in shard
    order and moved to the shard's device."""
    devs, n_local = _node_shards(mesh, N)
    return [draw_noise(generator, (n_local, A, spp), generator.device).to(d)
            for d in devs]


def tick_sharded(mesh: Mesh, tx_spps: torch.Tensor, gain, noise_var: float,
                 draws: list[torch.Tensor] | None = None,
                 generator: torch.Generator | None = None) -> list[torch.Tensor]:
    """Mesh-sharded vspace tick (dectnrp_tpu/simulation/vspace.py:158): the
    node axis of tx_spps [N, A, spp] sharded over mesh axis "node"; each
    shard weighs its nodes' TX into every receiver (identity antenna map,
    gain[j, i]: tx j -> rx i), a reduce-scatter psum over "node" gives it
    its own receivers' slice of the ether, then AWGN of variance noise_var
    from `draws` (draw_tick_sharded's list; drawn from `generator` when not
    given; one of the two is required). Returns the receivers' blocks
    [N / n_shards, A, spp], one a shard in shard order, each on its device.
    """
    if draws is None:
        if generator is None:
            raise ValueError("tick_sharded: give the noise draws or a generator")
        draws = draw_tick_sharded(generator, mesh, *tx_spps.shape)
    devs, n_local = _node_shards(mesh, tx_spps.shape[0])
    gain = torch.as_tensor(gain, dtype=torch.float32)
    contrib = []
    for i, d in enumerate(devs):
        own = slice(i * n_local, (i + 1) * n_local)
        g = gain[own].to(d, torch.complex64)                  # [n_local, N]
        contrib.append(torch.einsum("ji,jas->ias", g, tx_spps[own].to(d)))
    mine = psum(contrib, scatter_dim=0)                       # [n_local, A, spp]
    return [m + noise_var ** 0.5 * n for m, n in zip(mine, draws)]
