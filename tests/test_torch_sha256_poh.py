"""The port's SHA-256, PoH entry verification and bmtree
(firedancer_tpu_torch/ops/sha2.py `sha256`, ops/poh.py
`poh_verify_entries`, ops/bmtree.py; the plain versions of csrc/sha256.cu)
against the JAX package's ops/sha2.sha256, ops/poh.poh_verify_entries and
ops/bmtree.bmtree_root, and against hashlib and the host chains. Exact:
digests and verdicts are bytes and booleans."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import bmtree as jbm
from firedancer_tpu.ops import poh as jpoh
from firedancer_tpu.ops import sha2 as jsha2
from firedancer_tpu_torch.ops import bmtree, cuda_sha256, poh, sha2
from torch_hash_cases import poh_entries, rows

# the extra-block edges: len % 64 in 56..63 spills the bit length into a
# second block
EDGES = (0, 1, 55, 56, 63, 64, 119, 120, 200)
# PoH entries of every class (tests/torch_hash_cases.py): ticks, mixins,
# a mixin of one hash, 0 hashes, more plain hashes than the bound (the
# reference's scan clips there), flipped bytes in expected
MAX_HASHES = 16
# the reference's functions jitted whole: one compile each instead of one
# per eager op
J_SHA256 = jax.jit(jsha2.sha256)
J_BMTREE = jax.jit(jbm.bmtree_root, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("lo,hi", [(0, 50), (50, 100), (100, 150),
                                   (150, 201)])
def test_sha256_matches_jax_and_hashlib(lo, hi):
    """Every length 0-200 (four slices of the range, the edges 55, 56, 63,
    64, 119 and 120 among them) in rows of 200 bytes."""
    msg, ln = rows(range(lo, hi), 200, lo)
    got = sha2.sha256(torch.from_numpy(msg), torch.from_numpy(ln)).numpy()
    want = np.asarray(J_SHA256(jnp.asarray(msg), jnp.asarray(ln)))
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(ln):
        assert bytes(got[i]) == hashlib.sha256(bytes(msg[i, :n])).digest()


def test_sha256_edges_in_a_batch_shape():
    """A (2, 9) batch of rows: the plain version keeps leading dims, as
    the reference's does."""
    msg, ln = rows(EDGES * 2, 203, 5)
    msg, ln = msg.reshape(2, 9, 203), ln.reshape(2, 9)
    got = sha2.sha256(torch.from_numpy(msg), torch.from_numpy(ln)).numpy()
    want = np.asarray(J_SHA256(jnp.asarray(msg), jnp.asarray(ln)))
    np.testing.assert_array_equal(got, want)


def test_sha256_wrapper_takes_plain_path_for_cpu_tensors():
    msg, ln = rows(EDGES, 200, 6)
    before = dict(cuda_sha256.launches)
    got = cuda_sha256.sha256(torch.from_numpy(msg), torch.from_numpy(ln))
    assert cuda_sha256.launches == before     # no kernel on the CPU
    for i, n in enumerate(ln):
        assert bytes(got[i].numpy()) == \
            hashlib.sha256(bytes(msg[i, :n])).digest()


def test_sha512_padding_is_unchanged_by_the_sha256_parameters():
    """`_pad_message` serves both digests; its SHA-512 defaults keep the
    128-byte block and the 16-byte length."""
    msg, ln = rows((0, 111, 112, 300), 300, 7)
    buf, nb = sha2._pad_message(torch.from_numpy(msg), torch.from_numpy(ln),
                                int(sha2.nblocks(300)))
    assert nb.tolist() == [1, 1, 2, 3] and buf.shape == (4, 384)
    buf, nb = sha2._pad_message(torch.from_numpy(msg), torch.from_numpy(ln),
                                int(sha2.nblocks(300, 64, 8)), 64, 8)
    assert nb.tolist() == [1, 2, 2, 5] and buf.shape == (4, 320)


# -- PoH ------------------------------------------------------------------

@pytest.fixture(scope="module")
def poh_case():
    args, want = poh_entries(MAX_HASHES)
    jax_ok = np.asarray(jpoh.poh_verify_entries(
        *(jnp.asarray(a) for a in args), MAX_HASHES))
    return args, want, jax_ok


def test_poh_verify_entries_matches_jax(poh_case):
    args, want, jax_ok = poh_case
    got = poh.poh_verify_entries(*args, MAX_HASHES, device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_ok)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["zero_hashes", "clipped", "flipped",
                                  "mixin_of_one"])
def test_poh_verify_entries_edge_cases(poh_case, case):
    """The verdicts of each edge class, held to the reference's."""
    args, want, jax_ok = poh_case
    num, has = args[1], args[3]
    sel = {"zero_hashes": num == 0,
           "clipped": num > MAX_HASHES,
           "flipped": np.arange(len(num)) >= len(num) - 2,
           "mixin_of_one": (num == 1) & has}[case]
    assert sel.any()
    got = poh.poh_verify_entries(*(a[sel] for a in args), MAX_HASHES,
                                 device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_ok[sel])
    np.testing.assert_array_equal(got, want[sel])


def test_poh_chain_entry_arrays_verify():
    """PohChain's recorded entries verify as they stand, and not after
    one tick's declared hash count is off by one."""
    chain = poh.PohChain(bytes(range(32)))
    for k in range(6):
        chain.tick(3 + k)
        chain.record(bytes([k]) * 32, 1 + k % 3)
    args = chain.entry_arrays(MAX_HASHES)
    assert poh.poh_verify_entries(*args, MAX_HASHES, device="cpu").all()
    args[1][0] += 1
    ok = poh.poh_verify_entries(*args, MAX_HASHES, device="cpu")
    assert not ok[0] and ok[1:].all()


def test_poh_wrapper_counts_no_launch_on_the_cpu():
    args, _ = poh_entries(MAX_HASHES, 3)
    before = dict(cuda_sha256.launches)
    t = [torch.from_numpy(a) for a in args]
    cuda_sha256.poh_verify(*t, MAX_HASHES)
    assert cuda_sha256.launches == before


def test_poh_verify_entries_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    args, _ = poh_entries(MAX_HASHES, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        poh.poh_verify_entries(*args, MAX_HASHES)


# -- bmtree ---------------------------------------------------------------

PREFIXES = {"short": (bmtree.LEAF_PREFIX, bmtree.NODE_PREFIX),
            "shreds": (bmtree.LEAF_PREFIX_SHREDS, bmtree.NODE_PREFIX_SHREDS)}


@pytest.mark.parametrize("family", sorted(PREFIXES))
@pytest.mark.parametrize("counts", [(1, 2, 3, 4), (5, 8, 9, 16),
                                    (17, 31, 32, 33)])
def test_bmtree_root_matches_jax_and_host(family, counts):
    """Batches of four trees over 64 leaf slots, 1-33 live leaves, both
    prefix families."""
    lp, np_ = PREFIXES[family]
    rng = np.random.default_rng(sum(counts))
    leaves = rng.integers(0, 256, (4, 64, 32), np.uint8)
    cnt = np.array(counts, np.int32)
    got = bmtree.bmtree_root(leaves, cnt, 64, lp, np_, device="cpu").numpy()
    want = np.asarray(J_BMTREE(jnp.asarray(leaves), jnp.asarray(cnt), 64,
                               lp, np_))
    np.testing.assert_array_equal(got, want)
    for t, c in enumerate(counts):
        assert bytes(got[t]) == bmtree.host_bmtree_root(
            [bytes(x) for x in leaves[t, :c]], lp, np_)
        assert bytes(got[t]) == jbm.host_bmtree_root(
            [bytes(x) for x in leaves[t, :c]], lp, np_)


def test_bmtree_root_unbatched_and_depth():
    leaves = np.arange(8 * 32, dtype=np.uint8).reshape(8, 32)
    got = bmtree.bmtree_root(leaves, 6, 8, device="cpu").numpy()
    assert bytes(got) == bmtree.host_bmtree_root([bytes(x) for x in
                                                  leaves[:6]])
    assert [bmtree.bmtree_depth(n) for n in (1, 2, 3, 64, 65)] \
        == [jbm.bmtree_depth(n) for n in (1, 2, 3, 64, 65)] \
        == [0, 1, 2, 6, 7]


def test_bmtree_levels_are_one_sha256_call_each():
    """1 + log2(max_leaves) batched SHA-256 calls, whatever the batch."""
    calls = []
    orig = bmtree.cuda_sha256.sha256

    def counted(msg, ln):
        calls.append(msg.shape)
        return orig(msg, ln)
    bmtree.cuda_sha256.sha256 = counted
    try:
        bmtree.bmtree_root(np.zeros((3, 16, 32), np.uint8),
                           np.array([16, 3, 1], np.int32), 16,
                           device="cpu")
    finally:
        bmtree.cuda_sha256.sha256 = orig
    assert calls == [(48, 33), (24, 65), (12, 65), (6, 65), (3, 65)]
