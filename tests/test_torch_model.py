"""The port's model, data, configs and schedules against the reference,
on the CPU.

`repro_torch.models.model.lm_loss` and its gradient are held against the
JAX package's `lm_loss` (``use_pallas=False``: its attention and scan
take their plain references) from the same JAX `init_params`, converted
by `params_from_jax`, on both ported smoke configs in float32 and on
SmolLM's in bfloat16. The data pipeline is held bit for bit, the LR
schedules and the config registry exactly. Tolerances are stated at each
test.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_one_core import one_core

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as r_smoke_config
from repro.configs import registry as r_registry
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models.model import init_params as r_init_params
from repro.models.model import lm_loss as r_lm_loss
from repro.optim import schedules as r_schedules
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.model import init_params, lm_loss
from repro_torch.optim import schedules
from repro_torch.tree import leaves, tree_map, unflatten

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _one_core():
    """Runs this file's tests on one core: its shapes are tiny, and the
    thread pools of XLA and torch would otherwise spin on every core that
    the timing-sensitive benchmark tests of the other workers use."""
    with one_core():
        yield


def _batch(vocab: int, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    tgt = np.concatenate([tok[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    tgt[0, :3] = -1  # masked targets inside the sequence too
    return tok, tgt


# (arch, dtype, loss rtol, per-leaf relative L2 gradient error): float32
# sums in another order; bfloat16 rounds activations at other places in
# the two frameworks (matmul outputs, the conv, the gates), ~2^-8 each
@pytest.mark.parametrize("arch,dtype,loss_rtol,grad_rtol", [
    ("smollm-135m", "float32", 1e-6, 1e-5),
    ("recurrentgemma-9b", "float32", 1e-6, 1e-5),
    ("smollm-135m", "bfloat16", 1e-3, 3e-2)])
def test_lm_loss_and_grads_match_reference(arch, dtype, loss_rtol, grad_rtol):
    rcfg = dataclasses.replace(r_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype)
    jp = r_init_params(rcfg, jax.random.PRNGKey(0))
    tok, tgt = _batch(cfg.vocab_size, 2, 48, 1)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, x, y: r_lm_loss(p, rcfg, x, y)))(
        jp, jnp.asarray(tok), jnp.asarray(tgt))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = lm_loss(live, cfg, torch.from_numpy(tok), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, leaves(live))
    assert abs(loss.item() - float(want_loss)) <= loss_rtol * abs(
        float(want_loss))
    got_g = leaves(params_to_numpy(unflatten(params, grads), cfg))
    want_g = [np.asarray(x, np.float32) for x in jax.tree.leaves(want_g)]
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= grad_rtol * np.linalg.norm(w) + 1e-12


def test_params_convert_round_trip():
    cfg = registry.get_smoke_config("recurrentgemma-9b")
    rcfg = dataclasses.replace(r_smoke_config("recurrentgemma-9b"),
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, r_init_params(rcfg, jax.random.PRNGKey(3)))
    params = params_from_jax(tree, dataclasses.replace(cfg, dtype="bfloat16"))
    assert params["embed"].dtype == torch.bfloat16
    assert len(params["segments"][0]) == 1 and len(params["segments"][1]) == 1
    back = params_to_numpy(params, cfg)
    for a, b in zip(jax.tree.leaves(tree), leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_init_params_shapes_match_reference():
    for arch in registry.ARCH_IDS:
        cfg = registry.get_smoke_config(arch)
        got = params_to_numpy(init_params(cfg, 0, "cpu"), cfg)
        want = jax.eval_shape(lambda: r_init_params(r_smoke_config(arch),
                                                    jax.random.PRNGKey(0)))
        assert [x.shape for x in leaves(got)] == \
            [x.shape for x in jax.tree.leaves(want)]


@pytest.mark.parametrize("seed,shards", [(0, 1), (5, 2)])
def test_synthetic_lm_batches_bit_for_bit(seed, shards):
    for shard in range(shards):
        kw = dict(vocab_size=512, seq_len=33, global_batch=4, seed=seed,
                  n_shards=shards, shard=shard)
        a, b = SyntheticLM(DataConfig(**kw)), RSyntheticLM(RDataConfig(**kw))
        for _ in range(3):
            for x, y in zip(a.next_batch(), b.next_batch()):
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y)
        assert a.state_dict() == b.state_dict() == {"step": 3}


@pytest.mark.parametrize("kind", ["cosine", "linear", "wsd"])
def test_schedules_match_reference(kind):
    for step in (0, 1, 7, 50, 99, 100, 130):
        want = float(r_schedules.get(kind)(step, 100))
        assert schedules.get(kind)(step, 100) == want
    if kind != "wsd":
        for step in (0, 3, 10, 40):
            want = float(r_schedules.get(kind)(step, 50, warmup=10))
            assert schedules.get(kind)(step, 50, warmup=10) == want


def test_registry_matches_reference_and_names_what_is_not_ported():
    """Every registry id resolves (xLSTM-350M was the last) to the
    reference's configs; what is still not ported, MTP, names ROADMAP.md
    §A8, and an unknown id raises KeyError."""
    assert registry.ARCH_IDS == r_registry.ARCH_IDS
    for arch in registry.ARCH_IDS:
        for get, rget in ((registry.get_config, r_registry.get_config),
                          (registry.get_smoke_config,
                           r_registry.get_smoke_config)):
            a, b = dataclasses.asdict(get(arch)), dataclasses.asdict(rget(arch))
            assert a.pop("use_kernels") and not b.pop("use_pallas")
            assert a == b
            segs = lambda c: [([dataclasses.astuple(bd) for bd in pat], n)
                              for pat, n in c.segments()]
            assert segs(get(arch)) == segs(rget(arch))
    mtp = dataclasses.replace(registry.get_smoke_config("deepseek-v3-671b"),
                              mtp=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A8"):
        init_params(mtp, 0, "cpu")
    with pytest.raises(KeyError):
        registry.get_config("xlstm-1b")


def test_port_imports_without_jax_or_reference():
    """Every module of repro_torch imports with jax and repro blocked."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):
            raise ImportError('blocked: ' + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              'repro_torch.')]
for m in mods:
    importlib.import_module(m)
assert not any(k.split('.')[0] in ('jax', 'repro') for k in sys.modules)
print(' '.join(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=SRC),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 45
    # the fault plane's host layer and numpy oracle, the batched trials,
    # the serve layer and the sharded engine among them
    assert {f"repro_torch.{m}" for m in (
        "core.routing", "core.notify", "core.majority", "core.simulator",
        "engine.numpy_backend", "engine.batched", "launch.serve",
        "engine.sharded", "launch.mesh")} <= mods
