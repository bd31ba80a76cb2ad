"""The port's token pipeline (``repro_torch.data.tokens``) on the CPU.

``_zipf_map`` is JAX's map, float32 ``pow`` and all: fed JAX's own
uniform draws as numpy, it gives JAX's tokens exactly.  The draws
themselves come from a ``torch.Generator`` (``jax.random`` cannot be
reproduced), so the rest checks the pipeline's properties: a batch is a
pure function of (seed, step, shard), steps and shards differ, labels
are the tokens shifted by one, and the ranks are Zipfian.
"""
import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.data import tokens as jtokens
from repro_torch.data import tokens as ttokens


@pytest.mark.parametrize("vocab,alpha", [(256, 1.1), (151_936, 1.1),
                                         (50_280, 1.3), (100, 0.7)])
def test_zipf_map_equals_jax_on_the_same_draws(vocab, alpha):
    u = jax.random.uniform(jax.random.key(vocab), (64, 257), minval=1e-6,
                           maxval=1.0)
    want = np.asarray(jtokens._zipf_map(u, vocab, alpha))
    got = ttokens._zipf_map(U.t(np.asarray(u)), vocab, alpha)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(U.n(got), want)


def test_batch_equals_jax_tokens_given_jax_draws():
    """JAX's batch_at_step is _zipf_map over its uniform draws, split into
    tokens and labels; the port's map on those draws gives that batch."""
    cfg = jtokens.TokenPipelineConfig(vocab_size=1000, seq_len=32,
                                      global_batch=4, seed=3)
    want = jtokens.host_batch_at_step(cfg, 5)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(3), 5), 0)
    u = jax.random.uniform(key, (4, 33), minval=1e-6, maxval=1.0)
    toks = U.n(ttokens._zipf_map(U.t(np.asarray(u)), 1000, 1.1))
    np.testing.assert_array_equal(toks[:, :-1], want["tokens"])
    np.testing.assert_array_equal(toks[:, 1:], want["labels"])


def test_determinism_steps_shards_and_shapes():
    cfg = ttokens.TokenPipelineConfig(vocab_size=100, seq_len=16,
                                      global_batch=8, seed=3)
    a = ttokens.host_batch_at_step(cfg, 5)
    b = ttokens.host_batch_at_step(cfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (8, 16) and a["tokens"].dtype == np.int32
    assert not np.array_equal(a["tokens"],
                              ttokens.host_batch_at_step(cfg, 6)["tokens"])
    other_seed = ttokens.TokenPipelineConfig(vocab_size=100, seq_len=16,
                                             global_batch=8, seed=4)
    assert not np.array_equal(
        a["tokens"], ttokens.host_batch_at_step(other_seed, 5)["tokens"])
    s0 = ttokens.host_batch_at_step(cfg, 5, shard=0, num_shards=2)
    s1 = ttokens.host_batch_at_step(cfg, 5, shard=1, num_shards=2)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert s0["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert 0 <= a["tokens"].min() and a["tokens"].max() < 100
    with pytest.raises(ValueError, match="shards"):
        ttokens.batch_at_step(cfg, 0, num_shards=3, device="cpu")


def test_batches_are_zipfian_and_placed_on_the_device():
    """Rank 0 is the most frequent token and the counts fall with rank;
    the batch lands on the device asked for (a card that is missing
    raises, as every entry point's)."""
    cfg = ttokens.TokenPipelineConfig(vocab_size=1000, seq_len=128,
                                      global_batch=64, seed=0)
    b = ttokens.batch_at_step(cfg, 0, device="cpu")
    assert b["tokens"].device.type == "cpu"
    counts = np.bincount(U.n(b["tokens"]).ravel(), minlength=1000)
    assert counts[0] == counts.max()
    assert counts[:10].sum() > counts[10:100].sum() / 2
    assert counts[:10].mean() > 10 * counts[100:].mean()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttokens.batch_at_step(cfg, 0)
