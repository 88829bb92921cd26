"""The port's headline run, ``tpu_pathtracer_torch/run_headline.py``, against
the repository's ``scripts/run_headline.py`` (the JAX package's): the same
ledger line and resume offset and a frame within fp noise, a resumed run
equal to an uninterrupted one, either package's checkpoint resumed, stale
and unreadable checkpoints started over, the supervisor's restarts, kills
and surrender, the refusal to run without a card unless the CPU is asked
for, and default outputs that are not the repository's committed records.
Both scripts render the Cornell box in place of the atrium (an atrium
frame takes ~20 s on one CPU core even at 32x32)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_pathtracer.cli
import tpu_pathtracer.utils.testscenes
from tpu_pathtracer_torch import run_headline
from tpu_pathtracer_torch.parallel.checkpoint import RenderState
from tpu_pathtracer_torch.scene import fixtures
from tpu_pathtracer_torch.utils.image import read_ppm
from test_torch_render import _assert_fp_noise
from test_torch_scene import same_host_path

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("HEADLINE_SPP", "HEADLINE_SIZE", "HEADLINE_CKPT", "HEADLINE_CKPT_EVERY",
       "HEADLINE_SPP_PER_PASS", "BENCH_RPB", "HEADLINE_OUT", "HEADLINE_LEDGER",
       "HEADLINE_SUPERVISE", "HEADLINE_STALL_S", "HEADLINE_MAX_RESTARTS",
       "TPU_PATHTRACER_TORCH_DEVICE", "TPU_PATHTRACER_PLATFORM")
# scripts/run_headline.py's ledger keys; the port adds the card.
JAX_KEYS = {"workload", "wall_s_this_run", "spp_rendered_this_run", "samples_per_s",
            "resumed_from_spp", "out"}
SIZE = 16


@pytest.fixture
def headline(tmp_path, monkeypatch, capsys):
    """``headline(package, tag, **env)`` runs that package's headline
    ``main`` on the Cornell box at 16x16 with outputs under ``tmp_path`` and
    the checkpoint ``tmp_path/<ck or tag>.npz``; returns (exit code, stdout
    lines, image or None, checkpoint path)."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)  # the JAX script makes out/ in its working directory
    monkeypatch.setattr(fixtures, "make_atrium_gltf",
                        lambda path, **_: fixtures.make_cornell_gltf(path))
    monkeypatch.setattr(tpu_pathtracer.cli, "setup_backend", lambda: None)
    testscenes = tpu_pathtracer.utils.testscenes
    monkeypatch.setattr(testscenes, "make_atrium_gltf", lambda path, **_: (
        testscenes.make_cornell_gltf(str(tmp_path / "jax_scene" / "cornell.gltf"))))

    def run(package, tag, ck=None, **env):
        ck = str(tmp_path / f"{ck or tag}.npz")
        out = str(tmp_path / f"{tag}.ppm")
        values = dict(HEADLINE_SIZE=SIZE, HEADLINE_CKPT=ck, HEADLINE_OUT=out,
                      HEADLINE_LEDGER=str(tmp_path / "ledger.jsonl"), **env)
        for name, value in values.items():
            monkeypatch.setenv(name, str(value))
        if package == "torch":
            monkeypatch.setenv("TPU_PATHTRACER_TORCH_DEVICE", "cpu")
            code = run_headline.main()
        else:
            monkeypatch.delenv("TPU_PATHTRACER_TORCH_DEVICE", raising=False)
            code = _jax_script().main()
        lines = capsys.readouterr().out.strip().splitlines()
        return code, lines, read_ppm(out).astype(int) if os.path.exists(out) else None, ck
    return run


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_headline", os.path.join(ROOT, "scripts", "run_headline.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(lines):
    """(progress lines, ledger line) of a run's stdout."""
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    return rows[:-1], rows[-1]


def test_torch_headline_matches_jax_script(headline, monkeypatch):
    """16x16 @ 4 spp in checkpoints of 2, seed 0: the same progress lines,
    ledger keys (the port's plus ``card``), workload and offsets, the line
    appended to the ledger file, and frames within fp noise."""
    same_host_path(monkeypatch)
    runs = {p: headline(p, p, HEADLINE_SPP=4, HEADLINE_CKPT_EVERY=2) for p in ("jax", "torch")}
    (jcode, jlines, jimg, _), (tcode, tlines, timg, _) = runs["jax"], runs["torch"]
    assert jcode == tcode == 0
    (jprog, jline), (tprog, tline) = _lines(jlines), _lines(tlines)
    assert [(r["spp_done"], r["spp_total"]) for r in tprog] == [(2, 4), (4, 4)]
    assert [(r["spp_done"], r["spp_total"]) for r in jprog] == [(2, 4), (4, 4)]
    assert all(set(r) == {"spp_done", "spp_total", "elapsed_s"} for r in tprog)
    assert set(jline) == JAX_KEYS and set(tline) == JAX_KEYS | {"card"}
    assert tline["card"] == "cpu"
    for key in ("workload", "spp_rendered_this_run", "resumed_from_spp"):
        assert tline[key] == jline[key], key
    assert tline["workload"] == f"enclosed-atrium 36 tris {SIZE}x{SIZE}@4spp"
    assert tline["samples_per_s"] == SIZE * SIZE * 4 / tline["wall_s_this_run"]
    with open("ledger.jsonl") as f:
        assert [json.loads(line) for line in f] == [jline, tline]
    assert timg.shape == (SIZE, SIZE, 3)
    _assert_fp_noise(jimg, timg)


def test_torch_headline_resumed_equals_uninterrupted(headline):
    """A 2-spp run resumed to 4 starts at 2, renders 2, and its frame and
    accumulator equal an uninterrupted 4-spp run's bit for bit."""
    code, _, _, ck = headline("torch", "half", HEADLINE_SPP=2, HEADLINE_CKPT_EVERY=2)
    assert code == 0 and RenderState.load(ck).samples_done == 2
    code, lines, resumed, ck = headline("torch", "resumed", ck="half", HEADLINE_SPP=4,
                                        HEADLINE_CKPT_EVERY=2)
    prog, line = _lines(lines)
    assert code == 0 and [r["spp_done"] for r in prog] == [4]
    assert (line["resumed_from_spp"], line["spp_rendered_this_run"]) == (2, 2)
    code, _, whole, whole_ck = headline("torch", "whole", HEADLINE_SPP=4, HEADLINE_CKPT_EVERY=2)
    assert code == 0
    np.testing.assert_array_equal(resumed, whole)
    a, b = RenderState.load(ck).accum, RenderState.load(whole_ck).accum
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_torch_headline_resumes_jax_checkpoint(headline, monkeypatch):
    """The JAX script's 2-spp checkpoint, resumed to 4 by the port: offset
    2, 2 rendered, and within fp noise of the port's uninterrupted frame."""
    same_host_path(monkeypatch)
    code, _, _, ck = headline("jax", "jax_half", HEADLINE_SPP=2, HEADLINE_CKPT_EVERY=2)
    assert code == 0 and RenderState.load(ck).samples_done == 2
    code, lines, resumed, _ = headline("torch", "resumed", ck="jax_half", HEADLINE_SPP=4,
                                       HEADLINE_CKPT_EVERY=2)
    line = _lines(lines)[1]
    assert code == 0 and (line["resumed_from_spp"], line["spp_rendered_this_run"]) == (2, 2)
    whole = headline("torch", "whole", HEADLINE_SPP=4, HEADLINE_CKPT_EVERY=2)[2]
    _assert_fp_noise(whole, resumed)


@pytest.mark.parametrize("fault", ["seed", "size", "unreadable"])
def test_torch_headline_starts_over_on_a_foreign_checkpoint(fault, headline, tmp_path):
    """A checkpoint of another seed or size, or one that cannot be read,
    counts as offset 0: the run renders every sample, equal to a fresh run,
    and leaves a valid checkpoint in its place."""
    ck = str(tmp_path / "foreign.npz")
    if fault == "unreadable":
        with open(ck, "wb") as f:
            f.write(b"not an npz")
    else:
        side = SIZE + 8 if fault == "size" else SIZE
        RenderState(np.ones((side * side, 3), np.float32), 1, side, side,
                    7 if fault == "seed" else 0).save(ck)
    assert run_headline.resume_offset(ck, SIZE, 2, 12345) == (None if fault == "unreadable" else 0)
    code, lines, img, _ = headline("torch", "over", ck="foreign", HEADLINE_SPP=2)
    line = _lines(lines)[1]
    assert code == 0 and (line["resumed_from_spp"], line["spp_rendered_this_run"]) == (0, 2)
    np.testing.assert_array_equal(img, headline("torch", "fresh", HEADLINE_SPP=2)[2])
    st = RenderState.load(ck)
    assert (st.samples_done, st.width, st.seed) == (2, SIZE, 0)


def test_torch_headline_resume_offset_clamped(tmp_path):
    """A checkpoint past ``spp`` resumes at ``spp``; a legacy file (no
    fingerprint) is taken, another fingerprint is not."""
    ck = str(tmp_path / "ck.npz")
    RenderState(np.zeros((SIZE * SIZE, 3), np.float32), 6, SIZE, SIZE, 0, 99).save(ck)
    assert run_headline.resume_offset(ck, SIZE, 4, 99) == 4
    assert run_headline.resume_offset(ck, SIZE, 8, 99) == 6
    assert run_headline.resume_offset(ck, SIZE, 8, 98) == 0
    RenderState(np.zeros((SIZE * SIZE, 3), np.float32), 3, SIZE, SIZE, 0, 0).save(ck)
    assert run_headline.resume_offset(ck, SIZE, 8, 98) == 3
    assert run_headline.resume_offset(str(tmp_path / "none.npz"), SIZE, 8, 98) == 0


def _child(code):
    return [sys.executable, "-c", code]


@pytest.mark.parametrize("case", ["restart", "progress", "stall", "gives_up"])
def test_torch_headline_supervisor(case, tmp_path, monkeypatch, capsys):
    """Stand-in children: one that fails once, then succeeds (restarted,
    exit 0); one that moves its checkpoint for longer than the stall limit
    (never killed); one that hangs (killed at the stall limit, restarted,
    given up); one that always fails (given up after the restarts, exit 1)."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    ck = tmp_path / "ck.npz"
    runs = tmp_path / "runs"
    monkeypatch.setenv("HEADLINE_CKPT", str(ck))
    monkeypatch.setenv("HEADLINE_SUPERVISE", "1")
    monkeypatch.setenv("HEADLINE_MAX_RESTARTS", "2")
    monkeypatch.setenv("HEADLINE_STALL_S", "1.5" if case == "progress" else "0.3")
    count = (f"import os, sys, time; p = {str(runs)!r}; n = os.path.getsize(p) if "
             f"os.path.exists(p) else 0; open(p, 'a').write('x'); "
             f"assert 'HEADLINE_SUPERVISE' not in os.environ; ")
    child = {
        "restart": count + "sys.exit(0 if n else 5)",
        "progress": count + f"[(open({str(ck)!r}, 'w').write(str(i)), time.sleep(0.2)) "
                            f"for i in range(12)]",
        "stall": count + "time.sleep(60)",
        "gives_up": count + "sys.exit(3)",
    }[case]
    code = run_headline.supervise(_child(child), poll_s=0.05, pause_s=0)
    events = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    want_code, want_events, starts = {
        "restart": (0, [("child_exit", 0)], 2),
        "progress": (0, [], 1),
        "stall": (1, [("stall_kill", 0), ("stall_kill", 1), ("stall_kill", 2)], 3),
        "gives_up": (1, [("child_exit", 0), ("child_exit", 1), ("child_exit", 2)], 3),
    }[case]
    assert code == want_code
    if want_code:
        assert events[-1] == {"supervisor": "gave_up", "restarts": 2}
        events = events[:-1]
    assert [(e["supervisor"], e["attempt"]) for e in events] == want_events
    assert os.path.getsize(runs) == starts
    if case == "restart":
        assert events[0]["rc"] == 5


@pytest.mark.parametrize("how", ["main", "module"])
def test_torch_headline_refuses_cpu_unless_asked(how, tmp_path, monkeypatch, capsys):
    """No CUDA and no ``TPU_PATHTRACER_TORCH_DEVICE=cpu``: exit 1 with
    ``cli.select_device``'s message, no line and no file written; the same
    through ``python -m tpu_pathtracer_torch.run_headline``."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in (("HEADLINE_CKPT", "ck.npz"), ("HEADLINE_OUT", "out.ppm"),
                        ("HEADLINE_LEDGER", "ledger.jsonl"), ("HEADLINE_SIZE", SIZE)):
        monkeypatch.setenv(name, str(tmp_path / str(value)) if name != "HEADLINE_SIZE" else str(value))
    if how == "main":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        code = run_headline.main()
        out, err = capsys.readouterr()
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        proc = subprocess.run([sys.executable, "-m", "tpu_pathtracer_torch.run_headline"],
                              cwd=ROOT, capture_output=True, text=True, timeout=120)
        code, out, err = proc.returncode, proc.stdout, proc.stderr
    assert code == 1 and out == ""
    assert "no CUDA device" in err and "TPU_PATHTRACER_TORCH_DEVICE=cpu" in err
    assert os.listdir(tmp_path) == []


def test_torch_headline_defaults(monkeypatch):
    """The JAX script's defaults, but the outputs: never the committed
    ``out/`` records, always under the git-ignored ``build/``."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    s = run_headline.settings()
    assert (s["spp"], s["size"], s["every"]) == (1000, 1000, 50)
    assert (s["config"].rays_per_batch, s["config"].spp_per_pass) == (65536, 16)
    assert (run_headline.POLL_S, run_headline.RESTART_PAUSE_S) == (20.0, 30.0)
    build = os.path.join(ROOT, "build") + os.sep
    for key in ("ckpt", "out", "ledger"):
        assert s[key].startswith(build), key
        assert not s[key].startswith(os.path.join(ROOT, "out")), key
    for committed in ("out/samples/atrium_1000x1000_1000spp.ppm", "out/headline_r4.json"):
        assert os.path.join(ROOT, committed) not in (s["out"], s["ledger"])
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
