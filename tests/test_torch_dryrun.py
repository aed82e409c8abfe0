"""``repro_torch.launch.dryrun`` on reduced combinations, each in a
subprocess as rank 0 of a ``"fake"`` group over a (2, 4) mesh: the
argument bytes it reports are exactly the rank's ``shard_params`` blocks
of the parameters (and their AdamW moments, and the inputs or the
cache), counted here from the specs alone; the step runs on meta tensors
and counts its FLOPs, its kernels' and its collectives.  One catalog
combination on the single pod, Gemma-3-12B's ``decode_32k``, holds the
cache in the production layout: a 256th of the whole cache a rank.
(``tests/test_torch_seq_parallel.py`` holds a dry run's collective bytes
against what rank 0 of a real gloo group counted in the same step.)"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from test_torch_seq_parallel import SHAPE, _cfg, dry_result, dry_run  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import is_spec  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

SIZES = dict(zip(("data", "model"), SHAPE))
# (config, phase, S, B, the kernels its step must stand for)
CASES = {"dense6-train": ("dense6", "train", 32, 8,
                          {"flash_attention", "flash_attention_bwd"}),
         "rglru-prefill": ("rglru", "prefill", 32, 4,
                           {"flash_attention", "rglru_gated_scan"}),
         "rwkv-decode": ("rwkv", "decode", 32, 4, {"wkv6"})}
# a catalog decode on the single pod (16, 16)
POD = ("gemma3-12b", "decode_32k", (16, 16))


def _block_bytes(cfg, sizes=SIZES) -> int:
    """The rank's parameter blocks' bytes under ``param_specs``."""
    whole = tree_flatten(init_params(cfg, None, "meta"))
    specs = tree_flatten(TM.param_specs(cfg, sizes["model"], sizes["data"]),
                         is_leaf=is_spec)
    total = 0
    for path, t in whole.items():
        n = math.prod(d // (sizes[a] if a else 1)
                      for d, a in zip(t.shape, specs[path]))
        total += n * t.element_size()
    return total


@pytest.fixture(scope="module")
def records():
    procs = {name: dry_run(_cfg(key, TC), (name, s, b, phase))
             for name, (key, phase, s, b, _) in CASES.items()}
    arch, shape, mesh = POD
    procs["pod"] = dry_run(TC.get_config(arch),
                           dataclasses.astuple(TC.INPUT_SHAPES[shape]), mesh)
    return {name: dry_result(p) for name, p in procs.items()}


@pytest.mark.parametrize("name", CASES)
def test_argument_bytes_are_the_shard_params_blocks(records, name):
    key, phase, s, b, _ = CASES[name]
    cfg = _cfg(key, TC)
    rec = records[name]
    assert rec["status"] == "ok" and rec["n_ranks"] == 8
    params = _block_bytes(cfg)
    if phase == "train":        # AdamW: two f32 moments, an int32 step
        n_params = params // 4                      # the configs are f32
        want = params + 2 * 4 * n_params + 4 + b * s * 8
    else:
        from repro_torch.launch.specs import abstract_cache
        mesh = dataclasses.make_dataclass(
            "M", ["mesh_dim_names", "shape"])(("data", "model"), SHAPE)
        cache = abstract_cache(cfg, TC.InputShape(name, s, b, phase), mesh)
        want = params + dryrun.tree_bytes(cache) + b * (
            s if phase == "prefill" else 1) * 8
    assert rec["argument_bytes"] == want, (rec["argument_bytes"], want)


@pytest.mark.parametrize("name", CASES)
def test_the_step_counts_its_work(records, name):
    rec = records[name]
    kernels = CASES[name][4]
    assert set(rec["kernel_flops"]) == kernels, rec["kernel_flops"]
    assert all(v > 0 for v in rec["kernel_flops"].values())
    assert rec["flops"] > sum(rec["kernel_flops"].values())
    assert rec["peak_bytes"] >= rec["argument_bytes"]
    assert rec["fits_80gb"] and rec["seconds"] > 0
    assert sum(rec["collectives"].values()) > 0


def test_long_context_skips_a_full_attention_architecture():
    rec = dryrun.run_one(TC.get_config("llama3-405b"),
                         TC.INPUT_SHAPES["long_500k"], (16, 16))
    assert rec["status"] == "skip" and "long-context" in rec["reason"]


def test_live_bytes_follow_frees_and_views():
    with dryrun.LiveBytes() as mem:
        a = torch.empty(1024, device="meta")        # 4 KiB
        b = a[:10].clone()                          # + 40 B
        c = a.view(32, 32)                          # a view: nothing new
        del a, c
        d = torch.empty(2048, device="meta")        # a freed: 40 + 8 KiB
    assert mem.peak == 8192 + 40, mem.peak
    del b, d


def test_a_pod_rank_holds_a_256th_of_the_decode_cache(records):
    """Gemma-3-12B's ``decode_32k`` on (16, 16): the rank's cache blocks
    (``pos`` whole aside) are the whole cache's bytes over 256, and its
    argument bytes its parameter blocks, that cache and the tokens."""
    from repro_torch.launch.specs import abstract_cache
    from repro_torch.models.transformer import init_cache
    arch, name, sizes = POD
    cfg, shape = TC.get_config(arch), TC.INPUT_SHAPES[name]
    mesh = dataclasses.make_dataclass(
        "M", ["mesh_dim_names", "shape"])(("data", "model"), sizes)
    cache = abstract_cache(cfg, shape, mesh)
    whole = init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
    pos = shape.global_batch * 8
    assert (dryrun.tree_bytes(cache) - pos) * 256 == (
        dryrun.tree_bytes(whole) - pos)
    rec = records["pod"]
    assert rec["status"] == "ok" and rec["n_ranks"] == 256, rec
    params = _block_bytes(cfg, dict(zip(("data", "model"), sizes)))
    assert rec["argument_bytes"] == (params + dryrun.tree_bytes(cache)
                                     + shape.global_batch * 8)
    assert rec["fits_80gb"], rec["peak_bytes"]
