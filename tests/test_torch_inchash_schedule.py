"""A CPU twin of the `inchash` kernel's one-launch schedule
(``src/repro_torch/kernels/csrc/inchash.cu``), held bit for bit against the
kernel's plain version, the 32-bit numpy mirror and `inchash_pallas` in
interpret mode.

The twin runs the kernel's protocol step by step in plain numpy: each
block draws a ticket and reads the generation in one step (one atomic add
on the work area's ticket word), the last ticket resets the counter, bumps
the generation and sweeps the next status words past the call's tiles; each tile publishes its XOR aggregate, looks
back over its predecessors' status words 32 at a time (a word is ready only
with the call's tag and a flag) and publishes its inclusive prefix; the
tile's own scan runs in the kernel's register order (warp, item, lane).
A scheduler interleaves the blocks' steps in a random order drawn from a
seed, or runs the highest ticket first, so that a tile looks back before
its predecessors publish and meets the words an earlier, larger call left.
Every word a look-back accepts must have been written by the same call.

Tolerance: exact (integer arithmetic). Inputs are made with numpy from a
seed. JAX runs without 64-bit mode here, so `inchash_pallas` is handed the
columns' low 32 bits, as its own ``.astype(jnp.uint32)`` takes them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.inchash import inchash_pallas
from repro_torch.core.hashing import entry_hash32_np
from repro_torch.kernels import inchash as ih

TILE = ih.TILE
WARPS, ITEMS = 16, 8                    # 512 threads x 8 items a tile
AGGREGATE, PREFIX = 1, 2                # the status words' flags


def _log(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(1_600_000_000_000_000_000, 1_800_000_000_000_000_000, n)
    c = rng.integers(0, 1000, n)
    r = rng.integers(0, 2 ** 40, n)
    for col in (d, c, r):
        neg = rng.random(n) < 0.05
        col[neg] = -rng.integers(1, 2 ** 62, int(neg.sum()))
    return d, c, r


class Area:
    """The kernel's work area: ticket counter, generation, sweep cursor and
    ``cap`` status words (value, flag, tag), plus which call wrote each
    word (the twin's own bookkeeping)."""

    def __init__(self, cap, tag_bits=ih.TAG_BITS, sweep=ih.SWEEP):
        self.counter = self.gen = self.cursor = 0
        self.value = np.zeros(cap, np.uint32)
        self.flag = np.zeros(cap, np.int64)
        self.tag = np.zeros(cap, np.int64)
        self.writer = np.full(cap, -1)
        self.cap, self.tag_mask, self.sweep = cap, (1 << tag_bits) - 1, sweep
        self.calls = 0

    def store(self, j, tag, flag, value, call):
        self.value[j], self.flag[j], self.tag[j] = value, flag, tag
        self.writer[j] = call


class Block:
    """A block's steps (a `_block` generator), its ticket once drawn, and
    whether its last step waited."""

    def __init__(self):
        self.steps, self.ticket, self.spinning = None, None, False


def _tile_scan(v):
    """Inclusive XOR scan of one tile's TILE values in the kernel's order:
    warp w holds entries [256 w, 256 w + 256), item k of lane l is entry
    256 w + 32 k + l; each warp scans item by item over its lanes, then
    the warps before it are XORed in."""
    x = v.reshape(WARPS, ITEMS, 32)
    lanes = np.bitwise_xor.accumulate(x, axis=2)          # warp_inclusive_xor
    item_tot = lanes[:, :, 31]
    before_item = np.bitwise_xor.accumulate(item_tot, axis=1) ^ item_tot
    warp_tot = np.bitwise_xor.reduce(item_tot, axis=1)
    before_warp = np.bitwise_xor.accumulate(warp_tot) ^ warp_tot
    return (lanes ^ before_item[:, :, None]
            ^ before_warp[:, None, None]).reshape(-1)


def _block(area, blk, h, prefix, call, stale):
    """One block of the kernel, as a generator: it yields after each step
    that touches the work area ("spin" while a look-back waits)."""
    n = h.shape[0]
    tiles = -(-n // TILE)
    gen, t = area.gen, area.counter     # one atomic add on the ticket word
    area.counter += 1
    blk.ticket = t
    assert t < tiles, "a ticket past the last tile: the area is torn"
    if t == tiles - 1:                   # every other ticket is taken
        area.counter = 0
        area.gen = (gen + 1) & 0xFFFFFFFF
        cur = area.cursor
        area.cursor = cur + area.sweep if cur + area.sweep < area.cap else 0
        for j in range(cur, cur + area.sweep):
            if tiles <= j < area.cap:
                area.store(j, 0, 0, 0, -1)
    yield "step"
    tag = gen & area.tag_mask
    v = np.zeros(TILE, np.uint32)        # ragged tail: XOR's identity
    v[:min(TILE, n - t * TILE)] = h[t * TILE:(t + 1) * TILE]
    agg = np.bitwise_xor.reduce(v)
    carry = np.uint32(0)
    if t == 0:
        area.store(0, tag, PREFIX, agg, call)
    else:
        area.store(t, tag, AGGREGATE, agg, call)
        yield "step"
        j = t - 1
        while True:                      # warp 0's look-back, 32 at a time
            at = j - np.arange(32)

            def read():
                ok = at >= 0
                a = np.where(ok, at, 0)
                return (np.where(ok, area.value[a], 0).astype(np.uint32),
                        np.where(ok, area.flag[a], PREFIX),
                        np.where(ok, area.tag[a], tag))

            value, flag, wtag = read()
            while not ((flag != 0) & (wtag == tag)).all():
                yield "spin"
                value, flag, wtag = read()
            pre = np.flatnonzero(flag == PREFIX)
            stop = pre[0] if pre.size else 31
            used = at[:stop + 1]
            stale.extend(int(a) for a in used[used >= 0]
                         if area.writer[a] != call)
            carry ^= np.bitwise_xor.reduce(value[:stop + 1])
            if pre.size:
                break
            j -= 32
        area.store(t, tag, PREFIX, carry ^ agg, call)
    yield "step"
    out = _tile_scan(v) ^ carry
    prefix[t * TILE:(t + 1) * TILE] = out[:min(TILE, n - t * TILE)]


def twin_call(area, d, c, r, rng, schedule="random"):
    """One inchash call through the twin: (h, prefix, stale words read).

    ``schedule`` "random" steps a block drawn at random each time;
    "descending" steps the highest ticket that is not waiting (blocks
    without a ticket first), so tiles look back before their predecessors
    publish."""
    n = d.shape[0]
    h = entry_hash32_np(*(x.astype(np.uint32) for x in (d, c, r)))
    prefix = np.zeros(n, np.uint32)
    if n == 0:
        return h, prefix, []
    tiles = -(-n // TILE)
    assert tiles <= area.cap
    area.calls += 1
    call, stale = area.calls, []
    live = []
    for _ in range(tiles):
        blk = Block()
        blk.steps = _block(area, blk, h, prefix, call, stale)
        live.append(blk)
    while live:
        if schedule == "random":
            blk = live[rng.integers(len(live))]
        else:
            ready = [b for b in live if not b.spinning]
            if not ready:                # every block waits: all retry
                for b in live:
                    b.spinning = False
                continue
            blk = max(ready, key=lambda b: (b.ticket is None, b.ticket or 0))
        try:
            blk.spinning = next(blk.steps) == "spin"
        except StopIteration:
            live.remove(blk)
            blk.spinning = False
        if not blk.spinning:             # progress: the waiting retry
            for b in live:
                b.spinning = False
    return h, prefix, stale


def _cap(tiles):
    """The wrapper's capacity rule for a new work area."""
    return max(ih.MIN_CAP, 1 << (tiles - 1).bit_length())


def _plain(d, c, r):
    h, pf = ih.inchash_plain(*(torch.as_tensor(x) for x in (d, c, r)))
    return h.numpy(), pf.numpy()


SIZES = [1, 255, 256, 257, TILE - 1, TILE, TILE + 1, 3 * TILE + 1]


@pytest.mark.parametrize("n", SIZES)
def test_twin_equals_the_plain_version_and_the_numpy_mirror(n):
    d, c, r = _log(n, seed=n)
    area = Area(_cap(-(-n // TILE)))
    want_h, want_pf = _plain(d, c, r)
    mirror = entry_hash32_np(*(x.astype(np.uint32) for x in (d, c, r)))
    np.testing.assert_array_equal(want_pf, np.bitwise_xor.accumulate(mirror))
    rng = np.random.default_rng(n)
    for schedule in ("random", "descending", "random"):
        h, pf, stale = twin_call(area, d, c, r, rng, schedule)
        np.testing.assert_array_equal(h, want_h)
        np.testing.assert_array_equal(pf, want_pf)
        assert stale == []
        assert area.counter == 0         # the last ticket reset it
    assert area.gen == 3


@pytest.mark.pallas
@pytest.mark.parametrize("n", SIZES)
def test_twin_equals_the_pallas_kernel(n):
    d, c, r = _log(n, seed=n + 1)
    want_h, want_pf = inchash_pallas(
        *(jnp.asarray(x.astype(np.uint32)) for x in (d, c, r)),
        block=TILE, interpret=True)
    h, pf, stale = twin_call(Area(_cap(-(-n // TILE))), d, c, r,
                             np.random.default_rng(n), "descending")
    np.testing.assert_array_equal(h, np.asarray(want_h))
    np.testing.assert_array_equal(pf, np.asarray(want_pf))
    assert stale == []


@pytest.mark.parametrize("schedule", ["random", "descending"])
def test_twin_large_small_large_calls_share_one_area(schedule):
    """The words a larger call left read as not ready: a different tag."""
    sizes = [20 * TILE + 5, 3, TILE + 1, 9 * TILE, 20 * TILE + 5, 1,
             21 * TILE]
    area = Area(_cap(21))
    rng = np.random.default_rng(5)
    for i, n in enumerate(sizes):
        d, c, r = _log(n, seed=100 + i)
        h, pf, stale = twin_call(area, d, c, r, rng, schedule)
        want_h, want_pf = _plain(d, c, r)
        np.testing.assert_array_equal(h, want_h)
        np.testing.assert_array_equal(pf, want_pf)
        assert stale == []
        assert area.counter == 0 and area.gen == i + 1


@pytest.mark.pallas
def test_twin_large_small_large_equals_the_pallas_kernel():
    area = Area(_cap(12))
    rng = np.random.default_rng(6)
    for i, n in enumerate([12 * TILE - 3, 257, 7 * TILE + 1]):
        d, c, r = _log(n, seed=200 + i)
        want_h, want_pf = inchash_pallas(
            *(jnp.asarray(x.astype(np.uint32)) for x in (d, c, r)),
            block=TILE, interpret=True)
        h, pf, stale = twin_call(area, d, c, r, rng, "descending")
        np.testing.assert_array_equal(h, np.asarray(want_h))
        np.testing.assert_array_equal(pf, np.asarray(want_pf))
        assert stale == []


@pytest.mark.parametrize("sweep", [0, ih.SWEEP])
def test_twin_sweep_keeps_a_wrapped_tag_from_matching_a_stale_word(sweep):
    """With 2 tag bits the tag comes round every 4 calls. A 40-tile call,
    three one-tile calls and the 40-tile call again: without the sweep the
    second large call's last tile looks back first and accepts the words
    of tiles 7..38 that the first one left (tag 0, flag set), and its
    prefix is wrong; with the sweep the small calls zeroed them."""
    area = Area(64, tag_bits=2, sweep=sweep)
    rng = np.random.default_rng(7)
    results = []
    for i, n in enumerate([40 * TILE, 1, 1, 1, 40 * TILE]):
        d, c, r = _log(n, seed=300 + i)
        _, pf, stale = twin_call(area, d, c, r, rng, "descending")
        results.append((np.array_equal(pf, _plain(d, c, r)[1]), stale))
    if sweep:
        assert all(ok and not stale for ok, stale in results)
    else:
        ok, stale = results[-1]
        assert stale and not ok
