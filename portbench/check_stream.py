"""How ``correct`` is decided for a stream of buffers: the buffers that
the timed path delivered to a listener, against what WORLD's
``Synthesis2`` delivers for the same frames pushed one at a time
(``reference/realtime.py``, float64).

A lane's delivered buffers come in segments, one an utterance: the
buffers of the utterance delivered while the window ran, from the j0-th
on (j0 > 0 for the utterance that a lane was playing when the window
opened), and whether the utterance ended in the window.  For each
checked lane:

buffers_off       buffers missing, repeated or out of order.  Buffer i of
                  a segment is expected at the reference's window
                  j0 + i; it is off where it lies past the reference's
                  count, or where one of the ``REACH`` windows on either
                  side matches it clearly better than its own: with an
                  error energy under ``MARGIN`` times its own window's.
                  So the number counts order, not precision: a buffer in
                  its place that is merely imprecise, as the control's
                  are, stays in its place, and a silent buffer among
                  silent windows too.  A segment that ended counts the
                  reference's windows it never delivered as off too.
y_err_db_median   check.block_err_db over 10 ms blocks of the lane's
                  delivered samples, each segment against the
                  reference's same samples, as copysynth's number.

A run reports the worst lane of each number (check.worst).
"""

import numpy as np

from .check import block_err_db

REACH = 8
MARGIN = 0.1


def buffers_off(delivered, j0, finished, y_ref, n_ref):
    """Off buffers of one segment: ``delivered`` (m, buffer_size), the
    reference's samples ``y_ref`` of its ``n_ref`` buffers."""
    delivered = np.asarray(delivered, np.float64)
    m, bs = delivered.shape
    ref = np.asarray(y_ref[:n_ref * bs]).reshape(n_ref, bs)
    off = 0
    for i in range(m):
        p = j0 + i
        if p >= n_ref:
            off += 1
            continue
        lo, hi = max(0, p - REACH), min(n_ref, p + REACH + 1)
        err = ((ref[lo:hi] - delivered[i]) ** 2).sum(1)
        off += bool(err.min() < MARGIN * err[p - lo])
    if finished:
        off += max(0, n_ref - (j0 + m))
    return off


def judge_lane(segments, fs):
    """The numbers of one checked lane: ``segments`` [(delivered (m,
    buffer_size), j0, finished, y_ref, n_ref)]."""
    off, got, want = 0, [], []
    for delivered, j0, finished, y_ref, n_ref in segments:
        delivered = np.asarray(delivered, np.float64)
        if not len(delivered):
            off += max(0, n_ref - j0) if finished else 0
            continue
        off += buffers_off(delivered, j0, finished, y_ref, n_ref)
        m, bs = delivered.shape
        ref = np.zeros(m * bs)
        part = np.asarray(y_ref, np.float64)[j0 * bs:(j0 + m) * bs]
        ref[:len(part)] = part
        got.append(delivered.reshape(-1))
        want.append(ref)
    y = np.concatenate(got) if got else np.zeros(0)
    y_ref = np.concatenate(want) if want else np.zeros(0)
    return {"y_err_db_median": block_err_db(y, y_ref, int(0.01 * fs)),
            "buffers_off": float(off)}
