"""Pathogen detection, the port against the JAX package on the CPU, on the
panel of ``tests/test_genomics_pipeline.py`` (virusA 3,000 and virusB
4,000 bases, seed 3): genome windows, ED scores and detection reports in
``ed`` and ``fm`` modes, with and without per-read lengths, all bitwise;
and ``IncrementalDetector`` equal to ``detect`` over the concatenation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import pathogen as jpath
from repro.data import genome as jG
from repro.kernels import ops as jops
from repro_torch.core import pathogen as tpath
from repro_torch.kernels import fabric as tfabric

CFG = dict(window=192)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain DPs here are chains of many small ops.  With several test
    workers on one machine, each spreading every op over all cores, the
    workers' thread pools spin against each other and this module runs
    ~20x slower than alone; one intra-op thread per worker avoids that.
    Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genomes():
    rng = np.random.default_rng(3)
    return {"virusA": jG.random_genome(rng, 3000),
            "virusB": jG.random_genome(rng, 4000)}


@pytest.fixture(scope="module")
def panels(genomes):
    return tpath.Panel.build(genomes), jpath.Panel.build(genomes)


@pytest.fixture(scope="module")
def reads(panels):
    rng = np.random.default_rng(4)
    r, _ = jG.sample_reads(rng, panels[1].genomes[0], n_reads=10,
                           read_len=96, error_rate=0.03)
    noise = rng.integers(1, 5, (4, 96)).astype(np.int32)
    lens = rng.integers(60, 97, 14)
    lens[0] = 96
    return np.concatenate([r, noise]), lens


def _same_report(got, want):
    assert got.counts == want.counts
    assert got.abundance == want.abundance
    assert got.present == want.present
    np.testing.assert_array_equal(got.read_assignment, want.read_assignment)
    np.testing.assert_array_equal(got.read_scores, want.read_scores)
    assert got.read_scores.dtype == want.read_scores.dtype


def test_panel_indexes_match_jax(panels):
    tp, jp = panels
    assert tp.names == jp.names
    for ti, ji in zip(tp.indexes, jp.indexes):
        np.testing.assert_array_equal(ti.sa, ji.sa)
        np.testing.assert_array_equal(ti.occ, ji.occ)


@pytest.mark.parametrize("length,window,overlap", [
    (3000, 192, 96), (4000, 512, 256), (100, 512, 64), (29_903, 512, 256),
    (10, 4, 3)])
def test_genome_windows_bitwise(length, window, overlap):
    g = jG.random_genome(np.random.default_rng(length), length)
    got = tpath._genome_windows(g, window, overlap)
    want = jpath._genome_windows(g, window, overlap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_windows_at_the_papers_scale():
    """pathogen-X (29,903 bases) and pathogen-Y (10,000) at window 512 and
    read length 256: 116 + 39 windows per read."""
    assert tpath._genome_windows(np.ones(29_903, np.int32), 512,
                                 256).shape == (116, 512)
    assert tpath._genome_windows(np.ones(10_000, np.int32), 512,
                                 256).shape == (39, 512)


@pytest.mark.parametrize("gi", [0, 1])
def test_score_reads_ed_bitwise(panels, reads, gi):
    tp, jp = panels
    cfg_t, cfg_j = tpath.DetectConfig(**CFG), jpath.DetectConfig(**CFG)
    got = tpath.score_reads_ed(reads[0], tp.genomes[gi], cfg_t, device=U.CPU)
    want = jpath.score_reads_ed(reads[0], jp.genomes[gi], cfg_j,
                                fabric="reference")
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_read_window_pairs_match_jax_layout(panels, reads):
    tp, _ = panels
    q, t = tpath.read_window_pairs(reads[0], tp.genomes[0],
                                   tpath.DetectConfig(**CFG), device=U.CPU)
    wins = jpath._genome_windows(tp.genomes[0], 192, overlap=96)
    assert q.dtype == t.dtype == torch.int32
    np.testing.assert_array_equal(U.n(q), np.repeat(reads[0], len(wins), 0))
    np.testing.assert_array_equal(U.n(t), np.tile(wins, (14, 1)))


def test_firehose_pairs_equal_jax_banded_align(panels, reads):
    """Every read x window score, not only the best: the port's plain
    banded_align on the pairs against JAX's op (reference target)."""
    tp, _ = panels
    cfg = tpath.DetectConfig(**CFG)
    q, t = tpath.read_window_pairs(reads[0][:5], tp.genomes[1], cfg,
                                   device=U.CPU)
    from repro_torch.kernels import ops as tops
    got = tops.banded_align(q, t, band=192, local=True)
    want = jops.banded_align(jnp.asarray(U.n(q)), jnp.asarray(U.n(t)),
                             band=192, match=2, mismatch=-4, gap=-2,
                             local=True, fabric="reference")
    np.testing.assert_array_equal(U.n(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["ed", "fm"])
@pytest.mark.parametrize("with_lens", [False, True])
def test_detect_bitwise(panels, reads, mode, with_lens):
    tp, jp = panels
    lens = reads[1] if with_lens else None
    before = tfabric.counters().get("fabric.dispatch.banded_align.reference",
                                    0)
    got = tpath.detect(tp, reads[0], tpath.DetectConfig(**CFG), mode=mode,
                       read_lens=lens, device=U.CPU)
    want = jpath.detect(jp, reads[0], jpath.DetectConfig(**CFG), mode=mode,
                        read_lens=lens, fabric="reference")
    _same_report(got, want)
    assert got.present["virusA"] and not got.present["virusB"]
    after = tfabric.counters()["fabric.dispatch.banded_align.reference"]
    assert after == before + 2


def test_detect_noise_only(panels):
    tp, jp = panels
    noise = np.random.default_rng(5).integers(1, 5, (12, 96)).astype(
        np.int32)
    got = tpath.detect(tp, noise, tpath.DetectConfig(**CFG), device=U.CPU)
    want = jpath.detect(jp, noise, jpath.DetectConfig(**CFG),
                        fabric="reference")
    _same_report(got, want)
    assert not any(got.present.values())


def test_fm_mode_needs_an_index(genomes, reads):
    panel = tpath.Panel.build(genomes, with_index=False)
    with pytest.raises(ValueError, match="with_index"):
        tpath.detect(panel, reads[0], mode="fm", device=U.CPU)
    with pytest.raises(ValueError):
        tpath.detect(panel, reads[0], mode="bwa", device=U.CPU)


@pytest.mark.parametrize("mode", ["ed", "fm"])
@pytest.mark.parametrize("splits", [(5,), (2, 9, 9)])
def test_incremental_equals_detect_over_concatenation(panels, reads, mode,
                                                      splits):
    tp, _ = panels
    cfg = tpath.DetectConfig(**CFG)
    whole = tpath.detect(tp, reads[0], cfg, mode=mode, read_lens=reads[1],
                         device=U.CPU)
    inc = tpath.IncrementalDetector(tp, cfg, mode=mode, device=U.CPU)
    bounds = [0, *splits, len(reads[0])]
    for a, b in zip(bounds[:-1], bounds[1:]):
        rep = inc.ingest(reads[0][a:b], reads[1][a:b])
    _same_report(rep, whole)
    _same_report(inc.report(), whole)
    assert inc.total_reads == 14


def test_incremental_empty():
    panel = tpath.Panel(names=["a"], genomes=[np.ones(50, np.int32)])
    inc = tpath.IncrementalDetector(panel, device=U.CPU)
    rep = inc.ingest(np.zeros((0, 8), np.int32))
    assert rep.counts == {"a": 0} and rep.read_assignment.shape == (0,)
    assert tpath.score_reads_ed(np.zeros((0, 8), np.int32), panel.genomes[0],
                                device=U.CPU).shape == (0,)


def test_detect_config_defaults():
    assert vars(tpath.DetectConfig()) == vars(jpath.DetectConfig())


def test_backward_search_reads_out_of_alphabet_tokens_as_jax(panels):
    """A seed holding the -1 sentinel of ``detect(read_lens=...)`` (or a 0
    pad, or any token outside 1..4) walks the FM search off its tables; JAX
    gathers clamp there, and the port's search must give the same counts
    and positions (it raised an IndexError before, and would fault on a
    card)."""
    from repro.core import fm_index as jfm
    from repro_torch.core import fm_index as tfm
    tp, jp = panels
    rng = np.random.default_rng(11)
    g = tp.genomes[0]
    seeds = np.stack([g[s: s + 12] for s in rng.integers(0, 2900, 12)])
    seeds = seeds.astype(np.int32)
    seeds[1, 7:] = -1
    seeds[2, :] = -1
    seeds[3, 5] = 0
    seeds[4, 0] = 7
    seeds[5, 11] = -9
    cnt, pos = tfm.backward_search(tp.indexes[0].device_arrays(U.CPU),
                                   U.t(seeds), max_hits=8)
    jcnt, jpos = jfm.backward_search(jp.indexes[0].device_arrays(),
                                     jnp.asarray(seeds), max_hits=8)
    np.testing.assert_array_equal(U.n(cnt), np.asarray(jcnt))
    np.testing.assert_array_equal(U.n(pos), np.asarray(jpos))
