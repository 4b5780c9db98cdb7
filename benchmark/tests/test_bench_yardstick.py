"""The frozen byte counts and kernel-name table against hand-worked values,
and the decode kernel's byte count against the function it was copied
from."""

import pytest

import yardstick

#: a decode launch at chain_32_symm's shape, by hand: 150 000 live
#: entries, 20-bit dest and 16-bit row fields, 8-bit codes, D = 1, 40
#: dictionary values, B = 65 536, 150 000 receive slots
SPEC = {"n_live": 150_000, "w_dest": 20, "w_row": 16, "code_bits": 8,
        "D": 1, "ndict": 40, "n_recv": 150_000}
#: dest words (150000·20 + 31)//32 + 1 = 93 751; row words
#: (150000·16 + 31)//32 + 1 = 75 001; 4·168 752 + 150 000 + 4 + 320
#: + 524 288 + 1 200 008
SPEC_BYTES = 675_008 + 150_000 + 4 + 320 + 524_288 + 1_200_008


def test_decode_bytes_by_hand():
    assert yardstick.packed_words(150_000, 20) == 93_751
    assert yardstick.packed_words(150_000, 16) == 75_001
    assert yardstick.decode_bytes(SPEC, 65_536) == SPEC_BYTES


@pytest.mark.parametrize("spec", [
    SPEC,
    {"n_live": 7, "w_dest": 3, "w_row": 5, "code_bits": 16, "D": 4,
     "ndict": 300, "n_recv": 64},
    {"n_live": 1 << 20, "w_dest": 23, "w_row": 17, "code_bits": 8, "D": 2,
     "ndict": 256, "n_recv": 1 << 20},
])
def test_decode_bytes_matches_chip_smoke(spec):
    import chip_smoke

    assert yardstick.decode_bytes(spec, 4096) == chip_smoke.decode_bytes(
        spec, 4096)


def test_apply_bytes_by_hand():
    # x read and y written: 16 B a state and column; 12 B an element
    assert yardstick.apply_bytes(1000, 5000, 1) == 16_000 + 60_000
    assert yardstick.apply_bytes(4_707_969, 10, 4) == 301_310_016 + 120
    assert yardstick.bound_s(3.35e12) == 1.0


@pytest.mark.parametrize("name, phase", [
    ("fused_decode_kernel(unsigned int const*, long, ...)", "compute"),
    ("void at::native::indexFuncLargeIndex<double, long, unsigned int, 2, "
     "2, -2, true, at::native::ReduceAdd>(...)", "accumulate"),
    ("Memcpy HtoD (Pinned -> Device)", "plan_h2d"),
    ("Memcpy DtoH (Device -> Pageable)", "exchange"),
    ("ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevKernelArgsStorage)",
     "exchange"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "compute"),
    ("void (anonymous namespace)::ell_terms_kernel<(anonymous namespace)"
     "::Real, 1>(...)", "compute"),
    ("void (anonymous namespace)::ell_tail_kernel<(anonymous namespace)"
     "::Real>(...)", "compute"),
    ("void at::native::FillFunctor<double>", "overhead"),
    ("something_else", "overhead"),
])
def test_classify_kernel_by_hand(name, phase):
    assert yardstick.classify_kernel(name) == phase


def test_receive_side_names_are_frozen():
    """``recv_dev_ms`` reads the ``accumulate`` entries: exactly these."""
    assert [k for k, ph in yardstick.KERNEL_PHASES if ph == "accumulate"] \
        == ["indexfunc", "index_add", "indexing_backward", "index_put",
            "scatter"]
