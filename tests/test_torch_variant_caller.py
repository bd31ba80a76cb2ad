"""The variant caller's inference half, the port against the JAX package on
the CPU: pileups (vectorized, loop oracle, incremental), candidate sites
and windows bitwise; the CNN with JAX's params carried across within 2e-5
(its convs on the port's ``conv1d`` plain version, the dense layers as
float32 products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import variant_caller as jvc
from repro.data import genome as jG
from repro_torch.core import variant_caller as tvc
from repro_torch.kernels import fabric as tfabric

TOL = 2e-5


@pytest.fixture(scope="module")
def aligned():
    """A 500-base genome with three SNPs, 60 reads of 80 bases sampled from
    the mutant (some unaligned, some running off the end)."""
    rng = np.random.default_rng(8)
    genome = jG.random_genome(rng, 500)
    mutated = genome.copy()
    for p in (100, 250, 251):
        mutated[p] = (mutated[p] % 4) + 1
    reads, pos = jG.sample_reads(rng, mutated, n_reads=60, read_len=80)
    pos = pos.copy()
    pos[::9] = -1
    pos[1] = 470
    return genome, reads, pos


def test_base_counts_and_pileups_bitwise(aligned):
    genome, reads, pos = aligned
    lens = np.random.default_rng(0).integers(10, 81, len(reads))
    for args in ((len(genome), reads, pos), (len(genome), reads, pos, lens),
                 (len(genome), reads[:0], pos[:0]),
                 (len(genome), reads, np.full(len(reads), -1))):
        np.testing.assert_array_equal(tvc.base_counts(*args),
                                      jvc.base_counts(*args))
    got = tvc.build_pileup(genome, reads, pos)
    np.testing.assert_array_equal(got, jvc.build_pileup(genome, reads, pos))
    np.testing.assert_array_equal(got,
                                  tvc.build_pileup_loop(genome, reads, pos))
    np.testing.assert_array_equal(
        tvc.build_pileup_loop(genome, reads, pos),
        jvc.build_pileup_loop(genome, reads, pos))
    assert got.shape == (500, tvc.N_FEATURES) and got.dtype == np.float32


@pytest.mark.parametrize("as_list", [False, True])
def test_pileup_state_bitwise(aligned, as_list):
    genome, reads, pos = aligned
    tstate, jstate = tvc.PileupState(genome), jvc.PileupState(genome)
    for a, b in ((0, 17), (17, 18), (18, 60)):
        batch = ([r[: 40 + i % 40] for i, r in enumerate(reads[a:b])]
                 if as_list else reads[a:b])
        tstate.ingest(batch, pos[a:b])
        jstate.ingest(batch, pos[a:b])
    np.testing.assert_array_equal(tstate.counts, jstate.counts)
    np.testing.assert_array_equal(tstate.features(), jstate.features())
    assert tstate.n_reads == jstate.n_reads == 60
    if not as_list:
        np.testing.assert_array_equal(
            tstate.features(), tvc.build_pileup(genome, reads, pos))


def test_sites_and_windows_bitwise(aligned):
    genome, reads, pos = aligned
    pile = jvc.build_pileup(genome, reads, pos)
    for kw in ({}, {"min_alt_frac": 0.05, "min_cov": 1.0}):
        got = tvc.candidate_sites(pile, **kw)
        np.testing.assert_array_equal(got, jvc.candidate_sites(pile, **kw))
    sites = tvc.candidate_sites(pile)
    assert 100 in sites.tolist()
    sites = np.concatenate([sites, [0, 499]])
    for window in (33, 17):
        np.testing.assert_array_equal(
            tvc.extract_windows(pile, sites, window),
            jvc.extract_windows(pile, sites, window))
    np.testing.assert_array_equal(tvc.genome_clip(np.array([0, 1, 4, 9])),
                                  jvc.genome_clip(np.array([0, 1, 4, 9])))


CONFIGS = {
    "small": dict(window=17, channels=(16, 32), hidden=32),
    "default": {},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_matches_jax(aligned, name):
    jcfg = jvc.CallerConfig(**CONFIGS[name])
    tcfg = tvc.CallerConfig(**CONFIGS[name])
    jparams = jvc.init(jax.random.key(1), jcfg)
    tparams = tvc.load_numpy_params(jax.tree.map(np.asarray, jparams), U.CPU)
    genome, reads, pos = aligned
    pile = jvc.build_pileup(genome, reads, pos)
    sites = np.random.default_rng(2).integers(0, 500, 24)
    wins = jvc.extract_windows(pile, sites, jcfg.window).astype(np.float32)
    jgt, jalt = jvc.apply(jparams, jnp.asarray(wins), jcfg,
                          fabric="reference")
    before = tfabric.counters().get("fabric.dispatch.conv1d.reference", 0)
    gt, alt = tvc.apply(tparams, U.t(wins), tcfg)
    assert (tfabric.counters()["fabric.dispatch.conv1d.reference"]
            == before + len(tcfg.channels))
    assert gt.shape == (24, tvc.N_GENOTYPES) and alt.shape == (24, 4)
    np.testing.assert_allclose(U.n(gt), np.asarray(jgt), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(U.n(alt), np.asarray(jalt), rtol=TOL,
                               atol=TOL)


def test_init_layout_matches_jax():
    cfg = tvc.CallerConfig()
    tparams = tvc.init(torch.Generator().manual_seed(0), cfg, device=U.CPU)
    jparams = jvc.init(jax.random.key(0), jvc.CallerConfig())
    assert tparams.keys() == jparams.keys()
    for k in tparams:
        for kk in ("w", "b"):
            assert tuple(tparams[k][kk].shape) == jparams[k][kk].shape
            assert tparams[k][kk].dtype == torch.float32
    # He scale: the first conv's weights have variance 2 / (K * Cin)
    w = tparams["conv1"]["w"]
    assert abs(float(w.var()) - 2.0 / (5 * 9)) < 0.01
    assert vars(tvc.CallerConfig())["channels"] == jvc.CallerConfig().channels
