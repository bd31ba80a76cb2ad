"""Synthetic genome / read generation.

Tokens follow the framework-wide convention: A,C,G,T = 1..4 (0 is reserved
for CTC blank / padding).  Host-side numpy generation — this mirrors real
pipelines where reference handling is host work while accelerators chew on
signals (the paper's CORE1/CORE2 role).
"""
from __future__ import annotations

import dataclasses

import numpy as np

BASES = np.array([1, 2, 3, 4], np.int32)


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(1, 5, size=length).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class MutationProfile:
    snp_rate: float = 0.002
    ins_rate: float = 0.0005
    del_rate: float = 0.0005


def mutate(rng: np.random.Generator, genome: np.ndarray,
           profile: MutationProfile = MutationProfile()):
    """Apply SNPs/indels; returns (mutated, variants) where variants is a list
    of (pos_in_reference, kind, ref_base, alt_base)."""
    out = []
    variants = []
    i = 0
    n = len(genome)
    # draw all randomness up-front for speed
    r = rng.random(n)
    snp_alt = rng.integers(1, 4, size=n)  # offset, see below
    ins_base = rng.integers(1, 5, size=n)
    p = profile
    while i < n:
        x = r[i]
        if x < p.snp_rate:
            alt = ((genome[i] - 1 + snp_alt[i]) % 4) + 1  # != ref guaranteed
            out.append(alt)
            variants.append((i, "SNP", int(genome[i]), int(alt)))
        elif x < p.snp_rate + p.ins_rate:
            out.append(genome[i])
            out.append(ins_base[i])
            variants.append((i, "INS", 0, int(ins_base[i])))
        elif x < p.snp_rate + p.ins_rate + p.del_rate:
            variants.append((i, "DEL", int(genome[i]), 0))
        else:
            out.append(genome[i])
        i += 1
    return np.array(out, np.int32), variants


def sample_reads(rng: np.random.Generator, genome: np.ndarray, *,
                 n_reads: int, read_len: int, error_rate: float = 0.0,
                 circular: bool = False):
    """Uniformly positioned reads, optional sequencing errors (sub only).

    Returns (reads (n, read_len) int32, positions (n,) int64).
    """
    n = len(genome)
    if circular:
        pos = rng.integers(0, n, size=n_reads)
        idx = (pos[:, None] + np.arange(read_len)[None, :]) % n
    else:
        pos = rng.integers(0, max(n - read_len, 1), size=n_reads)
        idx = pos[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]
    if error_rate > 0:
        mask = rng.random(reads.shape) < error_rate
        shift = rng.integers(1, 4, size=reads.shape)
        reads = np.where(mask, ((reads - 1 + shift) % 4) + 1, reads)
    return reads.astype(np.int32), pos


def revcomp(seq: np.ndarray) -> np.ndarray:
    """A<->T (1<->4), C<->G (2<->3), reversed."""
    return (5 - seq)[::-1].astype(seq.dtype)
