"""The port's trainer against the reference's, on the CPU.

`repro_torch.launch.train.run_plain` (3 steps; the SmolLM,
RecurrentGemma and Command-R (LayerNorm) smoke configs) and
`run_threshold` (SmolLM smoke, 2 pods, compress tau 1e-3, max inner 3,
6 steps) are held against the JAX package's `run_plain` /
`run_threshold` with the same arguments. The port starts from the
reference's own `init_params(cfg, PRNGKey(seed))` converted by
`params_from_jax`, and both draw the same `SyntheticLM` batches. The
reference's per-step outputs are read by wrapping the `jax.jit` its
training loop calls (`repro.launch.train.jax`): each jitted program's
results are recorded as the loop runs them.

Tolerances: losses 1e-5 relative and final parameters 1e-4 absolute
(float32 sums in another order through 3 AdamW steps of lr <= 3e-4);
the sync schedule and the sent bytes exactly.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from test_torch_one_core import one_core

import jax

import repro.launch.train as r_train
from repro.configs.registry import get_smoke_config as r_smoke_config
from repro.models.model import init_params as r_init_params
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import train
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.tree import leaves


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core: its shapes are tiny, and the
    thread pools of XLA and torch would otherwise spin on every core that
    the timing-sensitive benchmark tests of the other workers use."""
    with one_core():
        yield


class _RecordingJax:
    """Stands in for the `jax` module inside `repro.launch.train`: every
    `jit` it hands out records each call's outputs, in creation order."""

    def __init__(self):
        self.programs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        compiled, calls = jax.jit(fn, **kw), []
        self.programs.append(calls)

        def run(*args):
            out = compiled(*args)
            calls.append(out)
            return out

        return run


def _args(**kw):
    args = train.parser().parse_args(["--smoke", "--device", "cpu",
                                      "--log-every", "1"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _run_reference(monkeypatch, fn, args):
    rec = _RecordingJax()
    monkeypatch.setattr(r_train, "jax", rec)
    loss = fn(args)
    monkeypatch.setattr(r_train, "jax", jax)
    return loss, rec.programs


def _reference_init(arch, args):
    tree = jax.tree.map(np.asarray, r_init_params(
        r_smoke_config(arch), jax.random.PRNGKey(args.seed)))
    return params_from_jax(tree, get_smoke_config(arch))


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b",
                                  "command-r-35b"])
def test_run_plain_matches_reference(monkeypatch, arch):
    args = _args(arch=arch, steps=3, batch=2, seq_len=32)
    want_loss, (step_calls,) = _run_reference(monkeypatch, r_train.run_plain,
                                              args)
    res = train.run_plain(args, params=_reference_init(arch, args))
    want_losses = [float(out[2]["loss"]) for out in step_calls]
    assert res.loss == res.losses[-1]
    np.testing.assert_allclose(res.losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(res.loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(
        res.grad_norms, [float(out[2]["grad_norm"]) for out in step_calls],
        rtol=1e-4)
    got = leaves(params_to_numpy(res.params, get_smoke_config(arch)))
    want = jax.tree.leaves(step_calls[-1][0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)


def test_run_threshold_matches_reference(monkeypatch):
    args = _args(arch="smollm-135m", sync="threshold", pods=2,
                 compress_tau=1e-3, max_inner=3, steps=6, batch=4, seq_len=32)
    want_loss, (inner, sync, drift) = _run_reference(
        monkeypatch, r_train.run_threshold, args)
    res = train.run_threshold(args, params=_reference_init("smollm-135m",
                                                           args))
    assert res.n_syncs == len(sync) == 2 and res.sync_steps == [2, 5]
    want_losses = [float(np.mean(np.asarray(out[2]["loss"]))) for out in inner]
    np.testing.assert_allclose(res.losses, want_losses, rtol=1e-5)
    np.testing.assert_allclose(res.loss, want_loss, rtol=1e-5)
    # every element's |acc| is far from tau at these steps: the sent counts
    # agree exactly (no element within float noise of tau flips)
    want_bytes = [int(out[2]["sync_sent_bytes"]) for out in sync]
    assert res.sent_bytes == sum(want_bytes) > 0
    # after the last sync every pod holds the new agreement
    cfg = get_smoke_config("smollm-135m")
    pods = [leaves(params_to_numpy(p, cfg)) for p in res.params]
    for a, b, w in zip(*pods, jax.tree.leaves(sync[-1][1]["agreement"])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("flag", [["--ckpt-dir", "ckpt"], ["--fail-at", "2"]])
def test_unported_flags_stop_with_an_error(flag, tmp_path, monkeypatch):
    """The checkpoint flags (ported now; tests/test_torch_ckpt.py runs
    them) stop with an error where the reference's do: ``--fail-at``
    with no checkpoint to restore re-raises the injected failure, and
    ``--ckpt-dir`` over another model's checkpoint refuses its
    structure."""
    monkeypatch.chdir(tmp_path)  # "ckpt" lands in the test's directory
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq-len", "16",
            *flag]
    if flag[0] == "--ckpt-dir":
        train.main(argv + ["--steps", "1", "--arch", "recurrentgemma-9b"])
        assert os.listdir(tmp_path / "ckpt") == ["step_00000000"]
        with pytest.raises(ValueError, match="structure mismatch"):
            train.main(argv + ["--steps", "3"])
    else:
        with pytest.raises(RuntimeError, match="injected failure"):
            train.main(argv + ["--steps", "3"])


def test_cli_runs_on_the_cpu(capsys):
    train.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                "--seq-len", "16", "--log-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["step=0", "step=1"]
    assert all(ln.startswith("[train] ") for ln in lines)


def test_entry_points_default_to_cuda():
    args = train.parser().parse_args(["--smoke"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.run_plain(args)
