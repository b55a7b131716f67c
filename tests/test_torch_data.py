"""The port's copies of the reference's host-side data, array-equal:
the synthetic GSCD corpus (`make_dataset`, `batch_iterator`, the keyword
synthesizer) and the measurement stimuli of `data/audio.py`."""

import numpy as np
import pytest

from repro.data import audio as jaudio
from repro.data import gscd as jgscd
from repro_torch.data import audio as taudio
from repro_torch.data import gscd as tgscd


def test_classes_and_config():
    assert tgscd.CLASSES == jgscd.CLASSES and len(tgscd.CLASSES) == 12
    assert tgscd.KEYWORDS == jgscd.KEYWORDS
    assert tgscd.GSCDSynthConfig() == tgscd.GSCDSynthConfig()
    assert vars(tgscd.GSCDSynthConfig()) == vars(jgscd.GSCDSynthConfig())


@pytest.mark.parametrize("n_per_class,seed,split", [(2, 0, "train"), (3, 1, "test"), (1, 7, "train")])
def test_make_dataset_equals_reference(n_per_class, seed, split):
    ref = jgscd.make_dataset(n_per_class, seed=seed, unknown_split=split)
    port = tgscd.make_dataset(n_per_class, seed=seed, unknown_split=split)
    assert sorted(port) == ["audio", "label"]
    for key in ref:
        assert port[key].dtype == ref[key].dtype and port[key].shape == ref[key].shape
        np.testing.assert_array_equal(port[key], ref[key])
    assert np.bincount(port["label"], minlength=12).tolist() == [n_per_class] * 12


def test_unknown_splits_hold_disjoint_templates():
    templates = tgscd._make_unknown_templates(25)
    assert templates == jgscd._make_unknown_templates(25) and len(templates) == 25
    train = tgscd.make_dataset(2, seed=0, unknown_split="train")
    test = tgscd.make_dataset(2, seed=0, unknown_split="test")
    unk = tgscd.CLASSES.index("unknown")
    assert not np.array_equal(train["audio"][train["label"] == unk],
                              test["audio"][test["label"] == unk])


@pytest.mark.parametrize("batch,drop", [(5, True), (5, False), (24, True)])
def test_batch_iterator_equals_reference(batch, drop):
    data = tgscd.make_dataset(2, seed=3)
    ref = list(jgscd.batch_iterator(data, batch, seed=4, drop_remainder=drop))
    port = list(tgscd.batch_iterator(data, batch, seed=4, drop_remainder=drop))
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        for key in r:
            np.testing.assert_array_equal(p[key], r[key])


@pytest.mark.parametrize("word", ["yes", "stop", "go"])
def test_synth_keyword_equals_reference(word):
    cfg = tgscd.GSCDSynthConfig()
    port = tgscd.synth_keyword(np.random.default_rng(11), tgscd._TEMPLATES[word], cfg)
    ref = jgscd.synth_keyword(np.random.default_rng(11), jgscd._TEMPLATES[word],
                              jgscd.GSCDSynthConfig())
    assert port.dtype == np.float32 and port.shape == (16000,)
    np.testing.assert_array_equal(port, ref)


def test_stimuli_equal_reference():
    np.testing.assert_array_equal(taudio.sine(440.0, 0.1, phase=0.3), jaudio.sine(440.0, 0.1, phase=0.3))
    np.testing.assert_array_equal(taudio.multitone([300.0, 1200.0, 3100.0], 0.1),
                                  jaudio.multitone([300.0, 1200.0, 3100.0], 0.1))
    np.testing.assert_array_equal(taudio.white_noise(0.1, seed=5), jaudio.white_noise(0.1, seed=5))
    np.testing.assert_array_equal(taudio.silence(0.1), jaudio.silence(0.1))
