"""The plain reference that decides a run's ``correct``.

``world/`` is a frozen copy of world_tpu_torch's analysis and synthesis
modules as of the commit that added this benchmark (config, device,
models/{cheaptrick, codec, d4c, dio, harvest, harvest_contour, stonemask,
synthesis}, ops/{common, contour, fftpack, filterbank, iir, matlab, ola,
refine, rng, scan, stonemask, zerocross}), with these edits and nothing
else changed:

- every hand-kernel wrapper keeps its checks and calls its plain PyTorch
  version, on the CPU and on the card alike; the kernels' launch code,
  their ``.launches`` counters and the import of ``ops/_cuda.py`` are
  gone;
- the two float64 per-sample recurrences (decimate's IIR and Harvest's
  smoothing biquad) run as ``scipy.signal.lfilter`` on the host, the
  same recurrence in C;
- fast mode's normals are drawn as the configuration states them
  (``torch.Generator`` on the device, float32) and widened to the
  reference's type (``ops/rng.py: NOISE_DTYPE``);
- Harvest's refinement takes the fast path's formulation (JAX's direct
  DFT and window bound, ``harvest_refine_plain``, its tables in the
  row's type) in float64 too, so the reference is the configuration's
  algorithm in a higher precision.

It imports nothing of world_tpu_torch, of the JAX package or of JAX, so a
later change to the program cannot move it.  ``analysis.py`` runs one
padded row through it as the batch step runs a row.
"""
