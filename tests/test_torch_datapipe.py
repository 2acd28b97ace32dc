"""The port's copy of the data pipeline (``repro_torch.datapipe``) against
the JAX package's: batches bit-identical at several steps, per host
slice, through the prefetch iterator and after a restart at a step."""
import numpy as np
import pytest

from repro.datapipe import pipeline as jp
from repro_torch.datapipe import pipeline as tp

STEPS = (0, 1, 7, 12345, 2**31 + 5)


def _cfgs(**kw):
    d = dict(batch=8, seq_len=16, vocab=101, seed=3)
    d.update(kw)
    return jp.DataConfig(**d), tp.DataConfig(**d)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [{}, dict(n_codebooks=3),
                                dict(patch_tokens=5, d_model=12),
                                dict(vocab=151_936, seq_len=64, seed=0)])
def test_synthetic_batches_identical(kw):
    jc, tc = _cfgs(**kw)
    js, ts = jp.SyntheticSource(jc), tp.SyntheticSource(tc)
    for step in STEPS:
        for host in ((0, 1), (1, 2)):
            _equal(ts.batch(step, host), js.batch(step, host))


def test_memmap_batches_and_permutation_identical(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(37 * 16 + 1, dtype=np.int32).tofile(path)
    jc, tc = _cfgs(batch=4, seq_len=16)
    js, ts = jp.MemmapSource(jc, path), tp.MemmapSource(tc, path)
    assert ts.n_windows == js.n_windows == 37
    for step in range(12):
        _equal(ts.batch(step), js.batch(step))
    i = np.arange(5000, dtype=np.int64)
    for n, key in ((5000, 1), (37, 4), (2, 0)):
        np.testing.assert_array_equal(tp._feistel_perm(i[:n], n, key),
                                      jp._feistel_perm(i[:n], n, key))
    short = str(tmp_path / "short.bin")
    np.arange(8, dtype=np.int32).tofile(short)
    with pytest.raises(ValueError, match="shorter than one window"):
        tp.MemmapSource(tc, short)


def test_pipeline_after_a_restart_identical():
    """A pipeline restarted at step 5 yields the reference's batches 5..,
    the same as a run that never stopped."""
    jc, tc = _cfgs()
    js, ts = jp.SyntheticSource(jc), tp.SyntheticSource(tc)
    first = tp.make_pipeline(ts, start_step=0)
    run = [next(first) for _ in range(8)]
    first.close()
    again = tp.make_pipeline(ts, start_step=5)
    resumed = [next(again) for _ in range(3)]
    again.close()
    assert [s for s, _ in run] == list(range(8))
    assert [s for s, _ in resumed] == [5, 6, 7]
    for s, b in run:
        _equal(b, js.batch(s))
    for (s, b), (s0, b0) in zip(resumed, run[5:]):
        assert s == s0
        _equal(b, b0)
