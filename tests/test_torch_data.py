"""The port's synthetic training data, on the CPU.

`jax.random` bits are not reproduced, so `repro_torch.data.SyntheticLM`
is held to the reference's formula and properties: batches are a pure
function of (seed, step); tokens are int32 in [0, V), each a step of 0-6
(mod V) from the one before; labels are the tokens rolled left by one;
the mask zeroes the last position; everything lies on the requested
device. `host_shard` slices the leading axis as the reference's does.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.data import host_shard as rhost_shard  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.data import SyntheticLM, host_shard  # noqa: E402


def _data(**kw):
    args = dict(vocab_size=1000, seq_len=64, global_batch=6, seed=3,
                device="cpu")
    args.update(kw)
    return SyntheticLM(**args)


def test_batches_are_a_function_of_seed_and_step():
    a, b = _data().batch(5), _data().batch(5)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["tokens"], _data().batch(6)["tokens"])
    assert not torch.equal(a["tokens"], _data(seed=4).batch(5)["tokens"])


@pytest.mark.parametrize("step", [0, 1, 17])
def test_batch_follows_the_reference_formula(step):
    V = 1000
    batch = _data(vocab_size=V).batch(step)
    toks, labels, mask = batch["tokens"], batch["labels"], batch["mask"]
    assert toks.shape == labels.shape == mask.shape == (6, 64)
    assert toks.dtype == labels.dtype == torch.int32
    assert mask.dtype == torch.float32
    assert int(toks.min()) >= 0 and int(toks.max()) < V
    assert torch.equal(labels, torch.roll(toks, -1, dims=1))
    assert bool((mask[:, -1] == 0).all()) and bool((mask[:, :-1] == 1).all())
    steps = (toks[:, 1:].long() - toks[:, :-1].long()) % V
    assert int(steps.min()) >= 0 and int(steps.max()) < 7
    # all seven drifts occur, and the rows start from different bases
    assert set(steps.unique().tolist()) == set(range(7))
    assert len(set(toks[:, 0].tolist())) > 1


def test_tokens_lie_on_the_requested_device():
    batch = _data().batch(0)
    assert all(x.device.type == "cpu" for x in batch.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SyntheticLM(10, 4, 2).batch(0)


def test_for_cell_takes_the_shape():
    cfg = get_config("qwen3_0p6b")
    data = SyntheticLM.for_cell(cfg, SHAPES["train_4k"], seed=1,
                                device="cpu")
    assert (data.vocab_size, data.seq_len, data.global_batch) == \
        (cfg.vocab_size, 4096, 256)
    # a frontend config's batches carry its stub embeddings
    for arch, name in (("seamless_m4t_medium", "frames"),
                       ("llama_3p2_vision_90b", "patches")):
        cfg = get_config(arch)
        data = SyntheticLM.for_cell(cfg, SHAPES["train_4k"], device="cpu")
        assert (data.frontend_name, data.n_frontend_tokens,
                data.frontend_dim) == (name, cfg.n_frontend_tokens,
                                       cfg.d_model)


@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_host_shard_matches_reference(n_hosts):
    batch = _data().batch(2)
    ref = {k: v.numpy() for k, v in batch.items()}
    parts = [host_shard(batch, h, n_hosts) for h in range(n_hosts)]
    for h, part in enumerate(parts):
        want = rhost_shard(ref, h, n_hosts)
        for k in batch:
            np.testing.assert_array_equal(part[k].numpy(), np.asarray(want[k]))
    assert torch.equal(torch.cat([p["tokens"] for p in parts]),
                       batch["tokens"])
