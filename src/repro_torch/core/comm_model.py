"""Data-transfer cost model (paper §II-B, §III-B).

Implements f_comm: the time to move the inter-stage tensor between device
pools, with
  * P2P FPGA<->GPU transfers over the PCIe root complexes (the paper's §III-B
    mechanism) vs. staging through CPU memory (~2x slower at >=1MB, much
    worse for small transfers — Fig. 6),
  * aggregate bandwidth = combined link bandwidth of the participating
    devices, capped by the narrower side,
  * the conflict-avoidance delay (§II-B): CPU-FPGA and FPGA-GPU transfers on
    the same root complex are serialized by one CPU-FPGA communication cycle,
  * interconnect projections: PCIe4.0 -> PCIe5.0 -> CXL3.0 bandwidth scaling
    (only the transfer time is projected, as in §VI-A).
"""
from __future__ import annotations

from .device import DeviceType, Interconnect


def effective_bw(src: DeviceType, n_src: int, dst: DeviceType, n_dst: int,
                 ic: Interconnect, *, bw_scale: float = 1.0) -> float:
    """Aggregate B/s between the pools: each pool contributes the sum of its
    devices' link bandwidths; the transfer runs at the narrower side,
    scaled by the interconnect generation. ``bw_scale`` is the hosting
    machine's bandwidth multiplier (``HostProfile.bw_scale``; < 1.0 = a
    host with narrower links than the modeled baseline)."""
    bw_src = src.link_bw * 1e9 * max(n_src, 1)
    bw_dst = dst.link_bw * 1e9 * max(n_dst, 1)
    return min(bw_src, bw_dst) * ic.scale * bw_scale


def transfer_time(nbytes: float, src: DeviceType, n_src: int,
                  dst: DeviceType, n_dst: int, ic: Interconnect,
                  *, p2p: bool | None = None, conflict: bool = False,
                  bw_scale: float = 1.0) -> float:
    """f_comm: one inter-stage transfer. Same-type pools exchange only the
    re-partitioning traffic (half the tensor on average). ``bw_scale``
    scales the host's effective bandwidth (see ``effective_bw``)."""
    if nbytes <= 0:
        return 0.0
    if p2p is None:
        p2p = ic.p2p
    if src.name == dst.name and n_src == n_dst:
        return 0.0                       # same pool keeps the data
    bw = effective_bw(src, n_src, dst, n_dst, ic, bw_scale=bw_scale)
    if p2p:
        t = ic.base_latency + nbytes / bw
    else:
        # staged through CPU memory: two hops + host involvement overhead
        t = 2.0 * ic.cpu_latency + 2.0 * nbytes / bw
    if conflict:
        # one CPU-FPGA communication cycle of separation (§II-B)
        t += ic.cpu_latency
    return t


def p2p_speedup(nbytes: float, src: DeviceType, dst: DeviceType,
                ic: Interconnect) -> float:
    """Fig. 6 reproduction: speedup of P2P over via-CPU for one transfer."""
    via_cpu = transfer_time(nbytes, src, 1, dst, 1, ic, p2p=False)
    p2p = transfer_time(nbytes, src, 1, dst, 1, ic, p2p=True)
    return via_cpu / p2p
