from .longform import analyze_long, synthesize_long
from .pipeline import (corpus_metrics, make_batch_step, make_mesh,
                       pad_and_bucket)

__all__ = ["analyze_long", "synthesize_long", "corpus_metrics",
           "make_batch_step", "make_mesh", "pad_and_bucket"]
