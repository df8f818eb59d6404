"""The check that decides ``correct``, at a tiny size on the CPU: the
reference agrees with the port; the control (the reference in float32
with bfloat16 between stages) and a run with its timed path broken come
out not correct; a sound run comes out correct."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, run
from portbench.reference import analysis as ra

CELLS = ["harvest_22k.copysynth", "dio_48k.features"]
PB = Path(__file__).resolve().parents[1]


def tiny(name):
    """The cell at a size a test run holds: batch cells 12 utterances of
    0.3-0.6 s, batches of 4, two checked rows a batch (one from each
    half); the long-form cell 2.9 s recordings in 1 s chunks, two lanes,
    three checked chunks (the first, the last and one between)."""
    cell = json.loads((PB / "workloads" / f"{name}.json").read_text())
    if cell["driver"] == "longform":
        cell["traffic"].update(seconds=2.9, chunk_s=1.0, batch_lanes=2)
        cell["check"].update(batches=1, rows=3, horizon=2)
    else:
        cell["traffic"].update(utterances=12, length_s=[0.3, 0.6],
                               buckets_s=[0.45, 0.65], batch=4)
        cell["check"].update(batches=2, rows=2, horizon=3)
    cell["trace"].update(skip=1, requests=1)
    return cell


def config(name):
    return json.loads((PB / "configs" / f"{name.split('.')[0]}.json")
                      .read_text())


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_in_float32_is_the_port_on_the_cpu(name):
    from world_tpu_torch.parallel.pipeline import make_batch_step
    c = config(name)
    fs = c["fs"]
    x = np.tile(np.fromfile(PB / "data" / f"golden_{fs}.f64"), 2)[
        :int(0.5 * fs)].astype(np.float32)[None]
    step = make_batch_step(fs, x.shape[1], f0_method=c["f0_method"],
                           with_synthesis=c["with_synthesis"],
                           codec_dims=c["codec_dims"], device="cpu")
    f0, sp, ap, y = step(torch.as_tensor(x))
    xt = torch.as_tensor(x)
    _, f0_ref = ra.f0_track(xt, fs, c["f0_method"])
    assert torch.equal(f0_ref, f0)
    sp_r, ap_r, coded = ra.envelopes(xt, f0, fs, c["codec_dims"])
    if coded is not None:
        assert torch.equal(coded[0], sp) and torch.equal(coded[1], ap)
    else:
        assert torch.equal(sp_r, sp) and torch.equal(ap_r, ap)
    if c["with_synthesis"]:
        assert torch.equal(ra.synthesize(f0, sp, ap, fs, x.shape[1]), y)


@pytest.mark.parametrize("name", CELLS + ["harvest_22k.longform"])
def test_a_sound_run_is_correct_and_the_faults_are_not(name):
    got = {}
    for fault in (None, "half", "alter"):
        res, lines, _ = run.run_cell(name, 2 ** 31 + 99, 0.5, False,
                                     device="cpu", fault=fault,
                                     cell=tiny(name))
        got[fault] = res["correct"]
        assert list(res)[-1] == "check"
    assert got == {None: True, "half": False, "alter": False}


@pytest.mark.parametrize("name", CELLS + ["harvest_22k.longform"])
def test_the_control_is_not_correct(name):
    import importlib
    cell, c = tiny(name), config(name)
    drv = importlib.import_module(
        f"portbench.drivers.{cell['driver']}").Driver(cell, c, 2 ** 33 + 1,
                                                      "cpu")
    drv.setup()
    drv.window(0.1, None)
    numbers = drv.check("cpu", control=True)
    correct, _ = check.verdict(numbers, cell["check"]["limits"])
    assert not correct
    assert numbers["f0_off_pct"] > cell["check"]["limits"]["f0_off_pct"]


def test_the_harness_refuses_to_run_without_a_card(tmp_path):
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload",
         "dio_48k.features", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
