"""Harvest's refinement stage against its roofline: the least time its
work needs (the refinement's operations and the refinement's and the
reliability pass's bytes, counted by work.harvest_refine on each traced
call's own arguments) over the device time of everything launched in
StageClock's ``harvest.refine`` range, in percent."""

from .. import work
from . import capture, roofline


def install(ctx):
    capture(ctx, "world_tpu_torch.models.harvest", "harvest_refine")


def read(ctx):
    return roofline(ctx, "harvest.refine", "harvest_refine",
                    work.harvest_refine)
