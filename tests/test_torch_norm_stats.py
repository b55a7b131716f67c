"""The trainer's normalizer in the port against the reference example's.

`examples/train_kws.py` records FV_Raw with the software frontend, fits
mu / sigma on the eager log of the training set (``mean(0)``,
``std(0) + 1e-3``) and normalizes both corpora through the pipeline;
`repro_torch.training.kws.corpus_features` does the same on the port's
side. On one seeded corpus the stats and the FV_Norm Q6.8 codes are
array-equal.
"""

import jax.numpy as jnp
import numpy as np

from repro.core import quant as jq
from repro.core.fex import FExConfig, FExNormStats
from repro.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro.data.gscd import make_dataset
from repro_torch.training import kws

TEST_CLIPS = 4


def _reference(train_audio, test_audio):
    """`examples/train_kws.py`'s feature extraction and normalization."""
    fcfg = FExConfig()
    pipe = KWSPipeline(KWSPipelineConfig(fex=fcfg))
    raw_tr = pipe.record_features(train_audio)
    raw_te = pipe.record_features(test_audio)
    log_tr = jq.log_compress_lut(jnp.asarray(raw_tr), 12, 10)
    stats = FExNormStats(
        mu=log_tr.reshape(-1, 16).mean(0),
        sigma=log_tr.reshape(-1, 16).std(0) + 1e-3,
    )
    pipe = KWSPipeline(KWSPipelineConfig(fex=fcfg), norm_stats=stats)
    ftr, fte = (np.asarray(pipe.features_from_raw(jnp.asarray(r))) for r in (raw_tr, raw_te))
    return stats, ftr, fte


def test_corpus_features_equal_the_examples_normalization(monkeypatch):
    """12 training clips (one a class: 744 frames, padded by 12 + 12 zeros
    to whole windows of 32) and 4 test clips."""
    train = make_dataset(1, seed=0, unknown_split="train")["audio"]
    test = make_dataset(1, seed=1, unknown_split="test")["audio"][:TEST_CLIPS]
    fit, fits = kws.fit_norm_stats, []

    def spy(*args, **kwargs):
        fits.append(fit(*args, **kwargs))
        return fits[-1]

    monkeypatch.setattr(kws, "fit_norm_stats", spy)
    ftr, fte = kws.corpus_features(train, test, "cpu")
    jstats, jtr, jte = _reference(train, test)
    (stats,) = fits
    np.testing.assert_array_equal(stats.mu.numpy(), np.asarray(jstats.mu))
    np.testing.assert_array_equal(stats.sigma.numpy(), np.asarray(jstats.sigma))
    assert ftr.shape == jtr.shape == (12, 62, 16) and fte.shape == jte.shape
    np.testing.assert_array_equal(ftr.numpy(), jtr)
    np.testing.assert_array_equal(fte.numpy(), jte)
