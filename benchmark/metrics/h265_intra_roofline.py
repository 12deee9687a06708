"""K4's share of its roofline (%): the least time of its IDR calls in the
traced window (benchmark/roofline.py, bound by operations at these sizes)
over the time of its two kernels (carry and code pass) there. Nothing to
read in a window without an IDR."""

from benchmark.roofline import h265_intra_bound_s


def read(t):
    carry, code = t.context["k4_kernels"]
    calls = sum(1 for k in t.kernels if carry in k[0])
    spent = sum(b - a for name, a, b, _ in t.kernels
                if carry in name or code in name) / 1e9
    if not calls or spent <= 0:
        return None
    bound, _ = h265_intra_bound_s(*t.context["coded_size"])
    return 100.0 * calls * bound / spent
