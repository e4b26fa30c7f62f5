"""The traffic generators are functions of the seed: the same seed gives the
same lengths, arrivals, speakers and inputs, and two seeds differ, with the
same set of sizes."""

import numpy as np

from vocbench.drivers import batch, live, train
from vocbench.tests import tiny

SEEDS = (2 ** 33 + 5, 17)


def test_batch_calls_follow_the_seed():
    a, _ = tiny.context("iitp_base.batch", seed=SEEDS[0])
    b, _ = tiny.context("iitp_base.batch", seed=SEEDS[0])
    c, _ = tiny.context("iitp_base.batch", seed=SEEDS[1])
    ca, cb, cc = (batch.make_calls(x, 80) for x in (a, b, c))
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x["lengths"], y["lengths"])
        np.testing.assert_array_equal(x["mel"], y["mel"])
    assert any(not np.array_equal(x["lengths"], y["lengths"]) for x, y in zip(ca, cc))
    assert not np.array_equal(ca[0]["mel"][0, :10], cc[0]["mel"][0, :10])
    # the same set of lengths in another order, so a window's work does not move
    assert sorted(np.concatenate([x["lengths"] for x in ca])) == sorted(
        np.concatenate([x["lengths"] for x in cc]))
    assert batch.call_seed(a, 3) == batch.call_seed(b, 3) != batch.call_seed(c, 3)


def test_live_arrivals_follow_the_seed():
    a, _ = tiny.context("iitp_base_ms.live", seed=SEEDS[0])
    b, _ = tiny.context("iitp_base_ms.live", seed=SEEDS[1])
    x = live.make_arrivals(a, 4.0, 5.0, 80, 5)
    y = live.make_arrivals(a, 4.0, 5.0, 80, 5)
    z = live.make_arrivals(b, 4.0, 5.0, 80, 5)
    assert len(x) == len(z) == 20
    assert [r["at"] for r in x] == [r["at"] for r in y]
    assert [r["sid"] for r in x] == [r["sid"] for r in y]
    assert all(np.array_equal(p["mel"], q["mel"]) for p, q in zip(x, y))
    assert [r["at"] for r in x] != [r["at"] for r in z]
    assert sorted(len(r["mel"]) for r in x) == sorted(len(r["mel"]) for r in z)
    assert sorted(r["sid"] for r in x) == sorted(r["sid"] for r in z)
    ats = [r["at"] for r in x]
    assert ats == sorted(ats) and ats[0] == 0.0 and ats[-1] < 5.0


def test_train_corpus_follows_the_seed():
    a, _ = tiny.context("iitp_base.train", seed=SEEDS[0])
    b, _ = tiny.context("iitp_base.train", seed=SEEDS[1])
    lengths = train.corpus_lengths([32, 40, 48, 56], 33, 56, 2)
    assert lengths == [33, 40, 41, 48, 49, 56]
    x, y, z = train.make_clips(a, lengths), train.make_clips(a, lengths), train.make_clips(b, lengths)
    assert all(np.array_equal(p, q) for p, q in zip(x, y))
    assert not all(len(p) == len(q) and np.array_equal(p, q) for p, q in zip(x, z))
    assert sorted(map(len, x)) == sorted(map(len, z))
    assert len(set(map(len, x))) == len(x)  # the reference finds a row's clip by its length
