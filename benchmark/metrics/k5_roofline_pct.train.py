"""K5's share of its roofline: the least time of a forward and backward (one
bf16 similarity product and the two gradient products; the float32 features
in and their gradients out) times the calls the profiler kept, over K5's
device time: its own kernels and the bf16 operand pack and LSE pass it runs
(the LSE pass's column reduction where it follows K5's LSE kernel)."""
from benchmark import counts
from benchmark.trace import family, short_name

K5_SHARED = ("pack_operand_kernel", "lse_tc_kernel")


def read(t):
    s = t.shapes
    busy, last_lse = 0, ""
    for o in t.ops:
        name = short_name(o.name)
        if name.startswith("lse_"):
            last_lse = name
        if family(o.name) == "K5" or name in K5_SHARED or (name == "col_lse_reduce" and last_lse == "lse_tc_kernel"):
            busy += o.end_ns - o.start_ns
    calls = min(t.launches("loss_tc_kernel"), t.launches("dfeat_tc_kernel"))
    if calls == 0 or busy <= 0:
        return None
    n_bytes, ops = counts.k5_work(s["batch"], s["n_points"], (s["img"] // 8) ** 2,
                                 s["model"]["loftr_coarse"]["d_model"])
    return 100.0 * calls * counts.bound_s(n_bytes, ops, "bf16") / (busy / 1e9)
