"""The port's prefix cache (``repro_torch.serve.prefix_cache``, numpy
only) against the reference's ``repro.serve.prefix_cache`` on seeded
random churn: the same operations on both tries give the same ``match``,
the same ``acquire`` (length and segments), the same evictions and the
same ``stats()``, and both keep their structural invariants; then the
segment dtypes the scheduler hands it (a bf16 leaf as uint16 bits, int8
entries) round-trip bit for bit."""
import numpy as np
import pytest

from repro.serve import prefix_cache as ref_pc
from repro_torch.serve import prefix_cache as pc

KINDS = ("k0", "v0", "k_scale0")


def _segs(rng, n, dtype):
    """Slot snapshots of ``n`` tokens, (groups, n_kv, tokens, last)."""
    out = {}
    for kind in KINDS:
        last = 1 if "scale" in kind else 4
        if dtype == np.int8 and "scale" not in kind:
            out[kind] = rng.integers(-127, 128, (2, 2, n, last)).astype(
                np.int8)
        else:
            out[kind] = rng.integers(0, 2 ** 16, (2, 2, n, last)).astype(
                np.uint16)
    return out


def _same_acquire(a, b):
    (la, sa, ha), (lb, sb, hb) = a, b
    assert la == lb
    assert (ha is None) == (hb is None)
    if la:
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].dtype == sb[k].dtype
            np.testing.assert_array_equal(sa[k], sb[k])
    return ha, hb


@pytest.mark.parametrize("seed,capacity,dtype", [
    (0, None, np.uint16), (1, 40, np.uint16), (2, 24, np.int8),
    (3, 64, np.uint16)])
def test_churn_matches_reference(seed, capacity, dtype):
    """Random inserts, acquires, releases and lookups over prompts that
    share a few prefixes; every answer and every stat equal after each
    operation, evictions included."""
    rng = np.random.default_rng(seed)
    port, ref = pc.PrefixCache(capacity), ref_pc.PrefixCache(capacity)
    prefixes = [rng.integers(0, 50, int(rng.integers(2, 8)))
                for _ in range(3)]
    leases = []
    for _ in range(200):
        prompt = np.concatenate([prefixes[int(rng.integers(0, 3))],
                                 rng.integers(0, 50,
                                              int(rng.integers(0, 6)))])
        op = rng.random()
        if op < 0.35:
            segs = _segs(rng, len(prompt), dtype)
            ha = port.insert(prompt, segs)
            hb = ref.insert(prompt, segs)
            leases.append((ha, hb))
        elif op < 0.7:
            leases.append(_same_acquire(port.acquire(prompt),
                                        ref.acquire(prompt)))
        elif op < 0.9 and leases:
            ha, hb = leases.pop(int(rng.integers(0, len(leases))))
            port.release(ha)
            ref.release(hb)
        else:
            assert port.match(prompt) == ref.match(prompt)
        assert port.stats() == ref.stats()
        port.check()
    for ha, hb in leases:
        port.release(ha)
        ref.release(hb)
    assert port.stats() == ref.stats()
    if capacity is not None:
        assert port.stats()["evictions"] > 0


def test_release_and_capacity_contract():
    cache = pc.PrefixCache(4)
    with pytest.raises(ValueError, match="capacity_tokens"):
        pc.PrefixCache(0)
    rng = np.random.default_rng(0)
    h = cache.insert([1, 2, 3], _segs(rng, 3, np.uint16))
    cache.release(h)
    cache.release(h)             # a double release is a no-op
    cache.release(None)
    with pytest.raises(ValueError, match="tokens on axis"):
        cache.insert([1, 2], _segs(rng, 3, np.uint16))
    assert cache.stats()["pinned"] == 0
    cache.check()


def test_bf16_bits_round_trip():
    """The scheduler's bf16 leaves travel as uint16 bits: the segments
    come back from the trie bit for bit (the trie copies, never aliases)."""
    rng = np.random.default_rng(5)
    cache = pc.PrefixCache()
    segs = _segs(rng, 6, np.uint16)
    cache.insert(list(range(6)), segs)
    segs["k0"][...] = 0              # the caller's arrays are not aliased
    L, got, h = cache.acquire(list(range(5)) + [99])
    assert L == 5 and h is not None
    fresh = _segs(np.random.default_rng(5), 6, np.uint16)
    np.testing.assert_array_equal(got["k0"], fresh["k0"][:, :, :5])
    assert got["k0"].dtype == np.uint16
