"""StoneMask's stage against its roofline: the least time of its
refinement's work (work.stonemask_refine on each traced call's own
arguments) over the device time of everything launched in StageClock's
``stonemask`` range, in percent."""

from .. import work
from . import capture, roofline


def install(ctx):
    capture(ctx, "world_tpu_torch.models.stonemask", "stonemask_refine")


def read(ctx):
    return roofline(ctx, "stonemask", "stonemask_refine",
                    work.stonemask_refine)
