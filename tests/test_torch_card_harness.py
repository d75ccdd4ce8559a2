"""`chip_smoke.py` measures with the benchmark's yardsticks, not copies of
them: its kernel groups, work counts, peaks and seeded inputs are the very
objects of `port_bench`, so a kernel's bound and group are decided in one
place. It keeps no control that patches the shipped plans."""
import pytest
import torch

import chip_smoke
from port_bench import inputs, trace
from port_bench.work import block12, conv, gram, peaks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name, owner", [
    ("kernel_group", trace), ("b12_work", block12),
    ("gram_fwd_work", gram), ("gram_bwd_work", gram), ("conv_work", conv),
    ("smooth_image", inputs), ("textured_image", inputs),
    ("band_masks", inputs)])
def test_card_harness_takes_the_benchmarks_yardstick(name, owner):
    assert getattr(chip_smoke, name) is getattr(owner, name)


def test_card_harness_takes_the_benchmarks_peaks():
    assert chip_smoke.peaks is peaks
    assert not hasattr(chip_smoke, "HBM_BYTES_PER_S")
    assert not hasattr(chip_smoke, "PEAK_OPS")


@pytest.mark.parametrize("nbytes, ops, dtype, by", [
    (3.35e9, 1e9, "bfloat16", "bytes"),
    (1e6, 989e9, "bfloat16", "operations"),
    (1e6, 67e9, "float32", "operations"),
    (4e9, 67e9, "float32", "bytes")])
def test_bound_ms_is_the_benchmarks_bound_with_what_binds_it(nbytes, ops,
                                                             dtype, by):
    assert chip_smoke.bound_ms(nbytes, ops, dtype) == (
        peaks.bound_s(nbytes, ops, dtype) * 1e3, by)


def test_card_harness_keeps_no_plan_by_b_control():
    assert not [name for name in vars(chip_smoke)
                if name == "plans_split_by_b" or name.endswith("_plan_by_b")]
