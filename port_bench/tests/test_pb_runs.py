"""Each cell driven end to end on the CPU at 32^2 (the port's plain
versions): a sound run is correct and prints the contract's line; the
control (the plain reference in float8 in the program's place) and the
faults a cell can have come out not correct."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from helpers import ROOT, run_cpu
from port_bench import harness, judge, views
from port_bench.program import Program
from port_bench.reference.plain import Decoder

BENCH = harness.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, trace):
    r = run_cpu(cell, trace=bool(trace))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(BENCH, {"name": cell}, kind)}
    # on the CPU no operation runs on a device, so readers of the device
    # trace find nothing; the counted work is there
    got = set(r["metrics"])
    assert got <= want and (got == want if not trace else {
        m for m in want if m.startswith("mfu")} <= got)
    assert set(r["checks"]) == set(harness.load_cell(BENCH, cell)[3]["limits"])


def _opts(cell):
    return harness.load_cell(BENCH, cell)[3]["reference"]


def _control(cell):
    """Program entries that answer with the control instead."""
    cfg = harness.load_cell(BENCH, cell)[1]
    ref = Decoder(os.path.join(ROOT, cfg["decoder"]["file"]), cfg["decoder"], "cpu")
    opts = _opts(cell)

    def render_batch(self, latents, origins, dirs, **kw):
        ans = [judge.control_answer(ref, latents[f], origins[f], dirs[f], opts, False)
               for f in range(latents.shape[0])]
        return SimpleNamespace(depth=torch.stack([a["depth"] for a in ans]),
                               hit=torch.stack([a["hit"] for a in ans]))

    def render_frame(self, latent, camera):
        o, v = views.rays(camera.K, camera.R, camera.T, self.img)
        a = judge.control_answer(ref, latent, o, v, opts, True, polish=2)
        hw = (self.img, self.img)
        return SimpleNamespace(depth=a["depth"].reshape(hw), mask=a["hit"].reshape(hw),
                               normal=a["normal"].reshape(hw + (3,)))

    return render_batch, render_frame


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, monkeypatch):
    render_batch, render_frame = _control(cell)
    monkeypatch.setattr(Program, "render_batch", render_batch)
    monkeypatch.setattr(Program, "render_frame", render_frame)
    r = run_cpu(cell)
    assert not r["correct"] and r["failed"] > 0


BATCH_CELLS = [c for c in CELLS if harness.load_cell(BENCH, c)[2]["kind"] == "batch"]


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    real = Program.render_batch

    def half(self, latents, origins, dirs, **kw):
        h = max(1, latents.shape[0] // 2)
        st = real(self, latents[:h], origins[:h], dirs[:h], **kw)
        pad = lambda x, v: torch.cat([x, torch.full((latents.shape[0] - h,) + x.shape[1:],
                                                    v, dtype=x.dtype)])
        return SimpleNamespace(depth=pad(st.depth, 0.0), hit=pad(st.hit, False))

    monkeypatch.setattr(Program, "render_batch", half)
    r = run_cpu(cell)
    assert not r["correct"] and r["checks"]["hit_mismatch"]["value"] > 0.5


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    real_b, real_f = Program.render_batch, Program.render_frame

    def batch(self, *a, **kw):
        st = real_b(self, *a, **kw)
        return st._replace(depth=st.depth + 0.02)

    def frame(self, *a, **kw):
        out = real_f(self, *a, **kw)
        return out._replace(depth=out.depth + 0.02)

    monkeypatch.setattr(Program, "render_batch", batch)
    monkeypatch.setattr(Program, "render_frame", frame)
    r = run_cpu(cell)
    assert not r["correct"] and r["checks"]["residual_p99"]["value"] > 0.005


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, tmp_path):
    """On the card: the command itself, two seconds, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell,
                           "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_checkout_without_the_port_fails_on_the_card(tmp_path):
    """Only BENCHMARK.json and port_bench/: the run fails and prints no result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"), tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
