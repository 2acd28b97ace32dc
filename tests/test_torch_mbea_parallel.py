"""The port's process-parallel baseline (``repro_torch.baselines.mbea.
enumerate_parallel``, the ParMBE stand-in) against the JAX package's and
the serial oracle ``count_mbea``: the same count of maximal bicliques on
every graph of the test suite, exactly."""
import pytest

from repro.baselines.mbea import enumerate_parallel as j_enumerate_parallel
from repro.data import dataset_suite as j_dataset_suite
from repro_torch.baselines.mbea import (_par_init, _par_task, count_mbea,
                                        enumerate_parallel, _adj_ints)
from repro_torch.data.generators import dataset_suite, random_bipartite

SUITE = dataset_suite("test")


@pytest.mark.parametrize("name", sorted(SUITE))
def test_parallel_matches_the_reference_and_the_serial_oracle(name):
    g = SUITE[name]
    want = count_mbea(g)
    assert enumerate_parallel(g, workers=2) == want
    assert j_enumerate_parallel(j_dataset_suite("test")[name],
                                workers=2) == want


@pytest.mark.parametrize("order", ["degeneracy", "natural"])
def test_the_first_level_tasks_sum_to_the_serial_count(order):
    """The tasks run in this process (the pool's initializer and task
    functions) add up to the serial count in either root order."""
    g = random_bipartite(18, 26, 0.3, seed=5)
    adj = _adj_ints(g)
    roots = list(range(g.n_u))
    if order == "degeneracy":
        roots.sort(key=lambda v: adj[v].bit_count())
    _par_init(adj, g.n_v, order)
    assert sum(_par_task((i, roots)) for i in range(len(roots))) == \
        count_mbea(g, order=order)
