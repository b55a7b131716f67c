"""Host-side data of the port, numpy copies of `repro.data`: the synthetic
GSCD corpus (`gscd`) and measurement stimuli (`audio`)."""

from repro_torch.data.gscd import CLASSES, KEYWORDS, GSCDSynthConfig, make_dataset

__all__ = ["CLASSES", "KEYWORDS", "GSCDSynthConfig", "make_dataset"]
