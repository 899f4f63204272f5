"""The reference's per-device dot FLOPs of placed smoke train steps, for
tests/test_torch_analysis.py; run as a script in a process of its own
(4 host devices must be set before jax starts):

    python tests/_torch_placed_flops_reference.py BATCH SEQ ARCH...

For each architecture, `repro.analysis.hlo.flops_and_bytes` of the
compiled HLO of its smoke config's train step (``remat="block"``, as
the dry run's train cells) on a 2 x 2 ("data", "model") mesh, laid out
as the reference's dry run lays it out (`sanitize(param_specs)`, ZeRO-1
`opt_state_specs`, `input_specs_for`). Prints one JSON object {arch:
flops}.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.analysis.hlo import flops_and_bytes  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.configs.registry import get_smoke_config, input_specs  # noqa: E402
from repro.distributed import sharding as shd  # noqa: E402
from repro.launch import steps as S  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.model import abstract_params  # noqa: E402
from repro.optim.adamw import AdamWConfig, abstract_state  # noqa: E402


def placed_flops(arch: str, b: int, s: int) -> float:
    cfg = dataclasses.replace(get_smoke_config(arch), remat="block")
    shape = ShapeConfig("t", "train", s, b)
    mesh = make_mesh(2, 2)

    def named(tree):
        return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                            is_leaf=lambda x: isinstance(x, P))

    pa = abstract_params(cfg)
    ps = shd.sanitize(shd.param_specs(cfg), pa, mesh)
    os_ = shd.opt_state_specs(ps, pa, mesh, zero1=True)
    ins = input_specs(cfg, shape)
    insh = shd.input_specs_for(cfg, shape, mesh)
    with mesh:
        step = jax.jit(S.make_train_step(cfg, AdamWConfig()),
                       in_shardings=(named(ps), named(os_),
                                     named(insh["tokens"]),
                                     named(insh["targets"])),
                       out_shardings=(named(ps), named(os_), None))
        hlo = step.lower(pa, abstract_state(pa), ins["tokens"],
                         ins["targets"]).compile().as_text()
    return flops_and_bytes(hlo)["flops"]


if __name__ == "__main__":
    b, s = int(sys.argv[1]), int(sys.argv[2])
    print(json.dumps({a: placed_flops(a, b, s) for a in sys.argv[3:]}))
