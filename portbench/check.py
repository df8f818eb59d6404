"""How ``correct`` is decided: a sample of the rows that the timed path
produced, drawn from the seed, against the plain reference
(``reference/``) in float64 on the same padded rows.

For each checked row:

f0_off_pct        percent of the row's real frames voiced on either side
                  whose f0 is more than 1 cent off f0_ref, or voiced on
                  one side only.
sp_db_median      median over real frames and bins of |10 log10(sp /
                  sp_ref)|, sp_ref being CheapTrick on the row's own f0
                  (the program's output, read only to judge: each stage is
                  judged on what it was given).
ap_median         median |ap - ap_ref|, D4C on the row's own f0.
coded_sp_median,  the same of the coded sp and ap, where the cell codes
coded_ap_median   them.
y_err_db_median   10 log10 of the median, over the 10 ms blocks of the
                  row's real samples, of the block's error energy over
                  the mean block energy of y_ref, the synthesis of the
                  row's own f0, sp and ap.  The program's float32
                  synthesis is the reference's synthesis in float32, and
                  float32 places some pulses one sample off, and with
                  them the noise draws, where float64 rounds the other
                  way: that error fills the upper third or more of the
                  blocks in the program as in the control, so the error
                  summed over the row, a high percentile, or each block's
                  level does not tell the two apart; the median does.

A run reports the worst row of each number.  The control (``control``)
puts the reference in the program's place in the next precision down:
float32 with every stage's output, and the input, rounded to bfloat16.
"""

import numpy as np
import torch

from .reference import analysis as ra
from .reference.world import config as ref_config


def real_frames(fs, n):
    return ref_config.get_samples_for_dio(fs, n, ra.FRAME_PERIOD)


def f0_off_pct(f0, f0_ref, cents=1.0):
    live = (f0 > 0) | (f0_ref > 0)
    if not live.any():
        return 0.0
    a, b = f0[live], f0_ref[live]
    both = (a > 0) & (b > 0)
    off = ~both
    off[both] = np.abs(1200.0 * np.log2(a[both] / b[both])) > cents
    return 100.0 * float(off.mean())


def block_err_db(y, y_ref, block):
    """10 log10(median block error energy / mean block energy of y_ref)
    over whole blocks of ``block`` samples."""
    k = len(y_ref) // block
    e = ((y[:k * block] - y_ref[:k * block]) ** 2).reshape(k, block).sum(1)
    r = (y_ref[:k * block] ** 2).reshape(k, block).sum(1)
    return float(10.0 * np.log10(max(float(np.median(e)), 1e-300)
                                 / max(float(r.mean()), 1e-300)))


def judge_row(config, x, length, out, device):
    """The numbers of one row: ``x`` the padded row (float32 numpy, as the
    program got it), ``length`` its real samples, ``out`` the program's
    outputs for it (numpy; keys f0, sp, ap, y or f0, coded_sp,
    coded_ap)."""
    return judge(config, x, (0, real_frames(config["fs"], length)), out,
                 device, length)


def judge_chunk(config, row, core, out, device):
    """The numbers of one long-form chunk: ``row`` the chunk as the
    program cut it, ``core`` = (first, end) of the local frames that the
    stitched result takes from it, ``out`` the result on its local
    frames."""
    return judge(config, row, core, out, device, None)


def judge(config, x, frames, out, device, length):
    fs, method = config["fs"], config["f0_method"]
    f64 = torch.float64
    lo, nf = frames
    xr = torch.as_tensor(np.asarray(x, np.float64)[None], device=device)
    _, f0_ref = ra.f0_track(xr, fs, method)
    f0 = np.asarray(out["f0"], np.float64)
    nums = {"f0_off_pct": f0_off_pct(f0[lo:nf],
                                     f0_ref[0, lo:nf].cpu().numpy())}
    f0_t = torch.as_tensor(f0[None], dtype=f64, device=device)
    sp_ref, ap_ref, coded = ra.envelopes(xr, f0_t, fs, config["codec_dims"])
    if coded is not None:
        for key, ref in zip(("coded_sp", "coded_ap"), coded):
            got = np.asarray(out[key], np.float64)[lo:nf]
            nums[key + "_median"] = float(np.median(
                np.abs(got - ref[0, lo:nf].cpu().numpy())))
        return nums
    sp = np.asarray(out["sp"], np.float64)
    ap = np.asarray(out["ap"], np.float64)
    nums["sp_db_median"] = float(np.median(np.abs(10.0 * np.log10(
        sp[lo:nf] / sp_ref[0, lo:nf].cpu().numpy()))))
    nums["ap_median"] = float(np.median(np.abs(
        ap[lo:nf] - ap_ref[0, lo:nf].cpu().numpy())))
    if "y" in out:
        y_ref = ra.synthesize(f0_t, torch.as_tensor(sp[None], device=device),
                              torch.as_tensor(ap[None], device=device), fs,
                              len(x))
        y = np.asarray(out["y"], np.float64)[:length]
        y_ref = y_ref[0, :length].cpu().numpy()
        nums["y_err_db_median"] = block_err_db(y, y_ref, int(0.01 * fs))
    return nums


def control(config, x, device, synthesis):
    """The control's outputs for the padded row ``x``: the reference in
    float32, its input and every stage's output rounded to bfloat16
    (with the synthesis where ``synthesis``)."""
    fs = config["fs"]

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    xr = bf16(torch.as_tensor(np.asarray(x, np.float32)[None],
                              device=device))
    _, f0 = ra.f0_track(xr, fs, config["f0_method"])
    f0 = bf16(f0)
    sp, ap, coded = ra.envelopes(xr, f0, fs, config["codec_dims"])
    out = {"f0": f0[0].cpu().numpy()}
    if coded is not None:
        out["coded_sp"], out["coded_ap"] = (bf16(c)[0].cpu().numpy()
                                            for c in coded)
        return out
    sp, ap = bf16(sp), bf16(ap)
    out["sp"], out["ap"] = sp[0].cpu().numpy(), ap[0].cpu().numpy()
    if synthesis:
        out["y"] = bf16(ra.synthesize(f0, sp, ap, fs, xr.shape[1]))[0] \
            .cpu().numpy()
    return out


def worst(rows):
    """Each number's worst row (the largest: every number is an error)."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): correct when every number is at
    or under its limit; a number without a limit fails."""
    lines = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and np.isfinite(v) and v <= lim
             for _, v, lim in lines)
    return ok, lines
