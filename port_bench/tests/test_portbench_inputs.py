"""What a traffic file's `"masks"` does to a run's inputs and to the
entries and references that take them."""
import numpy as np
import pytest
import torch

from conftest import small_cell
from port_bench import harness, inputs
from port_bench.entries import Request, batch
from port_bench.reference import objective, precision


def pool(traffic: dict, seed: int = 2 ** 31 + 3):
    gen = torch.Generator().manual_seed(seed)
    return inputs.make_pairs(traffic, gen, "cpu")


def test_program_masks_draw_the_same_photos_and_no_masks():
    traffic = small_cell("config3.batch8_512")["traffic_file"]
    assert "masks" not in traffic
    bands = pool(traffic)
    program = pool(dict(traffic, masks="program"))
    assert len(bands) == len(program) == 16
    for b, p in zip(bands, program):
        np.testing.assert_array_equal(p.content, b.content)
        np.testing.assert_array_equal(p.style, b.style)
        assert p.content_masks is None and p.style_masks is None
        assert b.content_masks.shape == (4, 48, 48)
    explicit = pool(dict(traffic, masks="bands"))
    for b, e in zip(bands, explicit):
        for x, y in zip(b, e):
            np.testing.assert_array_equal(x, y)


def test_unknown_masks_are_refused():
    traffic = small_cell("config3.batch8_512")["traffic_file"]
    with pytest.raises(ValueError, match="masks"):
        pool(dict(traffic, masks="pspnet"))


def test_batch_entry_refuses_a_pool_without_masks():
    cell = small_cell("config3.batch8_512")
    pairs = pool(dict(cell["traffic_file"], masks="program"))[:8]
    ctx = harness.Context(harness.resolve(cell)[1], {}, torch.device("cpu"),
                          "no_masks_512")
    with pytest.raises(ValueError, match="no_masks_512"):
        batch.run_request(ctx, pairs, Request(2, 2, lambda: None))


def test_objective_reference_refuses_pairs_without_masks():
    cell = small_cell("config6.single_4096")
    pairs = pool(dict(cell["traffic_file"], masks="program"))[:1]
    with pytest.raises(ValueError, match="masks"):
        objective.reference_run(cell["config_file"], {}, pairs, 1,
                                precision.PLAIN, 48, 0, "cpu")
