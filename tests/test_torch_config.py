"""The port's StylizeConfig and PRESETS equal the JAX package's."""
import dataclasses

import pytest

from dpst_tpu import config as jcfg
from dpst_tpu_torch import config as tcfg


def test_field_names_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.StylizeConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.StylizeConfig)]
    assert tf == jf


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match(name):
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    assert (dataclasses.asdict(tcfg.PRESETS[name])
            == dataclasses.asdict(jcfg.PRESETS[name]))


@pytest.mark.parametrize("kw", [
    {"optimizer": "sgd"}, {"init_mode": "zeros"}, {"pooling": "min"},
    {"style_norm": "l1"}, {"laplacian_impl": "cuda"},
    {"style_layer_weights": (1.0,)}, {"scales": (256,), "scale_iters": (0,)},
    {"s2b_strips": -2}, {"history_terms": "none"},
])
def test_validation_matches(kw):
    with pytest.raises(ValueError):
        jcfg.StylizeConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.StylizeConfig(**kw)


def test_canonicalization_matches():
    for kw in ({"stream12": 1}, {"s2b_strips": 1}):
        assert (dataclasses.asdict(tcfg.StylizeConfig(**kw))
                == dataclasses.asdict(jcfg.StylizeConfig(**kw)))
