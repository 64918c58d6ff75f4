"""The port's lock registry is process-global: a test that provokes a lock
violation on purpose must give back the counts it moved.

``serve/locks.py`` keeps one registry per process, and it counts a
violation even when strict mode raises. ``tests/test_torch_server.py``
holds the service's ``/stats`` to ``order_violations == 0``, so a test
that ran earlier in the same process and left a violation behind would
fail it. :func:`preserved_lock_registry` saves the registry's strict
flag, count, violation list and warned set, and restores them on exit;
every test that provokes a violation runs its body under it.
"""

import contextlib

from dexiraft_tpu_torch.serve import locks


@contextlib.contextmanager
def preserved_lock_registry():
    """Run the body, then put the registry's strict flag, violation count,
    violation messages and warned set back as they were."""
    reg = locks._REGISTRY
    saved = (reg.strict, reg.order_violations, list(reg.violations),
             set(reg.warned))
    try:
        yield reg
    finally:
        reg.strict, reg.order_violations = saved[0], saved[1]
        reg.violations[:] = saved[2]
        reg.warned = saved[3]


def test_provoking_tests_give_back_the_violation_count():
    """The two tests that invert a nesting on purpose leave the count, the
    messages and the warned set where they found them."""
    from test_torch_serve_repairs import test_inverted_nesting_still_raises
    from test_torch_video import \
        test_ordered_lock_refuses_inverted_nesting_and_reentry

    before = locks.stats_record()
    reg = locks._REGISTRY
    warned = set(reg.warned)
    test_inverted_nesting_still_raises()
    test_ordered_lock_refuses_inverted_nesting_and_reentry()
    after = locks.stats_record()
    assert after["order_violations"] == before["order_violations"]
    assert after["violations"] == before["violations"]
    assert after["strict"] == before["strict"]
    assert reg.warned == warned


def test_preserved_registry_undoes_a_counted_violation():
    """Inside the context a violation is counted as usual; on exit the
    count is back."""
    start = locks.stats_record()
    with preserved_lock_registry():
        locks.set_strict(False)
        store = locks.OrderedLock("serve.sessions.store")
        stop = locks.OrderedLock("serve.server.stop")
        with store:
            with stop:  # inverted: counted, not raised
                pass
        assert (locks.stats_record()["order_violations"]
                == start["order_violations"] + 1)
    end = locks.stats_record()
    assert end["order_violations"] == start["order_violations"]
    assert end["strict"] == start["strict"]
