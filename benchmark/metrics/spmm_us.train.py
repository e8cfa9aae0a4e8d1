"""spmm_us.train: the device us of one SpMM launch in the traced window:
the device time of the kernels that ``spmm_roofline.train``'s PATTERNS
name, over the launches that the program's counter ``train.spmm`` counted
there (``Trainer`` adds a captured step's SpMM launches at each step,
``glass_tpu_torch.utils.profiling.span_table``). Layer: kernels.

Where ``spmm_roofline.train`` assumes one ``A @ x`` and one ``A^T @ g`` a
conv layer and step, this divides by the launches the program made, so a
path that launches more SpMMs than the equations need (a third a layer
under remat) shows here. Left out where the counter or the kernels are
absent: a program without the counter, or another path carrying the
product."""

from pathlib import Path

from benchmark import byname

PATTERNS = byname.load(Path(__file__).resolve().parent,
                       "spmm_roofline.train").PATTERNS


def read(run):
    from glass_tpu_torch.utils import profiling

    from benchmark.trace import kernel_seconds

    if run.mode != "train" or run.device_trace is None:
        return None
    launches = getattr(profiling, "span_table", dict)().get("train.spmm")
    spent = kernel_seconds(run.trace["kernels"], PATTERNS)
    if not launches or not launches["value"] or not spent:
        return None
    return spent / launches["value"] * 1e6
