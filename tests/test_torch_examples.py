"""The port's examples (``repro_torch.examples``) run headless on the CPU
(``--device cpu``, a small ``REPRO_EXAMPLE_N``) and print their reference
example's success lines, as ``tests/test_examples.py`` checks the
reference's. Each runs in a subprocess under ``OMP_NUM_THREADS=1`` with
its working directory, ``TMPDIR`` and ``HOME`` inside ``tmp_path``, and
writes nothing there but the checkpoint directory it is given."""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from repro_torch.examples import (
    distributed_search,
    quickstart,
    retrieval_serving,
    train_embedder,
)

ROOT = Path(__file__).resolve().parents[1]


def _run(name, tmp_path, *args, n=None):
    tmp = tmp_path / "tmp"
    home = tmp_path / "home"
    tmp.mkdir()
    home.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp), HOME=str(home),
               PYTHONDONTWRITEBYTECODE="1")
    if n is not None:
        env["REPRO_EXAMPLE_N"] = str(n)
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu", *args], capture_output=True, text=True, cwd=tmp_path,
        env=env, timeout=300)
    assert out.returncode == 0, (
        f"{name} failed\nSTDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}")
    return out.stdout


def _written(tmp_path):
    return sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")
                  if p.is_file())


def test_quickstart_runs_headless(tmp_path):
    out = _run("quickstart", tmp_path, n=3000)
    assert "all queries exact" in out
    assert "sims bit-identical" in out
    assert _written(tmp_path) == []


def test_distributed_search_runs_headless(tmp_path):
    # n divisible by the example's 8 shards; "devices: 8" of the
    # reference (8 fake XLA devices) becomes the shard and device count
    out = _run("distributed_search", tmp_path, n=4096)
    assert "shards: 8 on 1 device(s) (cpu)" in out
    assert "exact" in out
    assert _written(tmp_path) == []


def test_retrieval_serving_runs_headless(tmp_path):
    out = _run("retrieval_serving", tmp_path)
    assert "indexed 400 docs" in out
    assert out.count("(exact, streamed)") == 4
    assert "doc[11] solo: probes=" in out
    assert "generated 48 tokens for 6 requests" in out
    assert _written(tmp_path) == []


def test_train_embedder_tiny_runs_headless(tmp_path):
    """The example saves every 10 steps and keeps the newest 3
    checkpoints. Its trainer's straggler watchdog also saves at any step
    after 3 slow steps in a row (as the reference's does), which a loaded
    machine can cause; such a save takes the place of an older one. So
    the set is {10, 20, 30} whenever every kept step is a multiple of 10
    (no escalated save survived retention), and otherwise at most 3 steps
    up to 30, the last of them 30."""
    ckpt = tmp_path / "ckpt"
    out = _run("train_embedder", tmp_path, "--tiny", "--ckpt-dir", str(ckpt))
    assert "model: llama3-8b (0.1M params) on cpu" in out
    assert "steps: 30  restarts: 0" in out
    assert "loss: first10 " in out
    assert f"checkpoints in {ckpt} " in out
    names = {p.name for p in ckpt.iterdir()}
    assert "step_00000030" in names
    assert len(names) <= 3              # TrainerConfig.keep_checkpoints
    steps = set()
    for name in names:
        assert len(name) == 13 and name.startswith("step_") \
            and name[5:].isdigit(), name
        steps.add(int(name[5:]))
    assert max(steps) == 30
    if all(s % 10 == 0 for s in steps):
        assert steps == {10, 20, 30}
    assert all(w.startswith("ckpt/") for w in _written(tmp_path))


def test_train_embedder_defaults():
    """Its default checkpoint directory is its own, under the temporary
    directory (the reference's is ``repro_train_embedder``), and the
    default model is the reference's ~100M llama-family config."""
    d = Path(train_embedder.default_ckpt_dir())
    assert d.parent == Path(tempfile.gettempdir())
    assert d.name == "repro_torch_train_embedder"
    cfg = train_embedder.model_100m()
    assert cfg.activation == "swiglu" and not cfg.tie_embeddings
    assert 100e6 < cfg.param_count() < 130e6


@pytest.mark.parametrize("module", [quickstart, distributed_search,
                                    retrieval_serving, train_embedder])
def test_examples_default_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main([])
