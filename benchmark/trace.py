"""What a traced run reads from ``torch.profiler``, on the device's own timeline.

A traced window runs under the profiler with its events kept in memory; no
trace file is written. :func:`device_ops` takes the device operations
(kernels, copies, fills) out of the session, :class:`Trace` holds them with
the window's wall and the work done, and the per-layer readers in
``benchmark/metrics`` compute their numbers from it. Busy time is the union
of the device intervals; the idle share is taken over the span from the first
operation to the last, on the profiler's device clock alone (its map of the
device clock onto the host's can be off by tens of milliseconds, so the two
are never mixed).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

# kernel families of the port, by the names its CUDA sources give them
K1_NAMES = ("kv_partial_tc_kernel", "kv_reduce_tc_kernel", "apply_tc_kernel",
            "tcw_pack_kernel", "tcw_gemm_kernel", "tcw_kv_reduce_kernel", "tcw_ln_image_kernel",
            "tcw_ln_residual_kernel", "tcw32_pack_kernel", "tcw32_gemm_kernel", "tcw32_kv_reduce_kernel",
            "tcw32_ln_image_kernel", "tcw32_ln_residual_kernel")
K2_NAMES = ("pack_operand_kernel", "lse_tc_kernel", "col_lse_reduce", "argmax_tc_kernel", "col_argmax_reduce",
            "pack_tf32_operand_kernel", "lse_tf32x3_kernel", "argmax_tf32x3_kernel", "pack_wide_bf16_kernel",
            "lse_wide_bf16_kernel", "argmax_wide_bf16_kernel", "pack_tf32_hilo_kernel", "lse_wide_tf32x3_kernel",
            "argmax_wide_tf32x3_kernel")
K3_NAMES = ("window_gather_kernel", "window_span_kernel")
K4_NAMES = ("scatter_index_kernel", "window_sum_kernel")
# K5's own kernels; it also runs K2's bf16 operand pack and LSE pass (listed under K2)
K5_NAMES = ("loss_tc_kernel", "gsum_tc_kernel", "colg_reduce", "dfeat_tc_kernel", "loss_wide_kernel",
            "gsum_wide_kernel", "dfeat_wide_kernel")
K6_NAMES = ("patch_gather_kernel",)
K7_NAMES = ("short_encoder_tc_kernel", "short_encoder_kernel")
FAMILIES = {"K1": K1_NAMES, "K2": K2_NAMES, "K3": K3_NAMES, "K4": K4_NAMES, "K5": K5_NAMES,
            "K6": K6_NAMES, "K7": K7_NAMES}


def short_name(key: str) -> str:
    """A kernel's name without namespaces, template and function arguments."""
    m = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
    return m.group(1) if m else key[:60]


def family(name: str) -> Optional[str]:
    s = short_name(name)
    for fam, names in FAMILIES.items():
        if s in names:
            return fam
    return None


@dataclasses.dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int
    launch: str  # the host call that launched it ("" where none was kept)


def device_ops(prof) -> List[Op]:
    """The device operations of a profiler session, by start time."""
    events = prof.profiler.kineto_results.events()
    host = {}
    for e in events:
        if e.device_type().name != "CUDA" and e.correlation_id():
            host[e.correlation_id()] = e.name()
    ops = []
    for e in events:
        if e.device_type().name != "CUDA" or e.is_user_annotation() or e.duration_ns() <= 0:
            continue
        ops.append(Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                      host.get(e.linked_correlation_id(), "")))
    ops.sort(key=lambda o: o.start_ns)
    return ops


def union_ns(ops: Sequence[Op]) -> int:
    busy, end = 0, None
    for o in ops:
        if end is None or o.start_ns > end:
            busy += o.end_ns - o.start_ns
            end = o.end_ns
        elif o.end_ns > end:
            busy += o.end_ns - end
            end = o.end_ns
    return busy


def gaps(ops: Sequence[Op]) -> List[Tuple[int, Op]]:
    """(idle ns, the operation that ended it) for every gap between device operations."""
    out, end = [], None
    for o in ops:
        if end is not None and o.start_ns > end:
            out.append((o.start_ns - end, o))
        end = o.end_ns if end is None else max(end, o.end_ns)
    return out


@dataclasses.dataclass
class Trace:
    """A traced window: its device operations, wall, work and the cell's shapes."""
    ops: List[Op]
    window_s: float
    work: Dict[str, float]  # e.g. frames, objects, pairs, micro_batches completed in the window
    shapes: Dict  # what the cell ran: config, traffic and the sizes the counts need
    peak_bytes: int

    @property
    def busy_s(self) -> float:
        return union_ns(self.ops) / 1e9

    @property
    def span_s(self) -> float:
        return (self.ops[-1].end_ns - self.ops[0].start_ns) / 1e9 if self.ops else 0.0

    def family_ops(self, fam: str) -> List[Op]:
        return [o for o in self.ops if family(o.name) == fam]

    def launches(self, short: str) -> int:
        return sum(1 for o in self.ops if short_name(o.name) == short)

    def seconds(self, ops: Sequence[Op]) -> float:
        return sum(o.end_ns - o.start_ns for o in ops) / 1e9

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations (families K1-K7 grouped) that took most time,
        and the ten longest idle gaps named by what the host launched to end them."""
        by: Dict[str, float] = {}
        for o in self.ops:
            key = family(o.name) or short_name(o.name)
            by[key] = by.get(key, 0.0) + (o.end_ns - o.start_ns) / 1e9
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        longest = sorted(gaps(self.ops), key=lambda g: -g[0])[:10]
        idle = [[f"{o.launch or 'host'} -> {family(o.name) or short_name(o.name)}", ns / 1e9]
                for ns, o in longest]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": idle}
