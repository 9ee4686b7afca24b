"""The frozen roofline count against the hand counts of the cells' shapes."""

import pytest

from benchmark import roofline, spec


def test_cohere10m_f1p_is_operations_bound_at_3_94_ms():
    cell = spec.cell("cohere10m.f1p")
    live = cell.rows - spec.keep_from(cell.mix, cell.rows)  # 9,900,000 rows kept
    t, by, bytes_moved, ops = roofline.for_config(cell.config, live, 256)
    assert by == "operations"
    assert ops == 2.0 * 256 * 768 * 9_900_000
    assert t * 1e3 == pytest.approx(3.94, abs=0.005)  # 3.893e15 / 989e12
    # the bytes: each kept row once with 12 bytes of side data, 7.72 GB
    assert bytes_moved / 1e9 == pytest.approx(9_900_000 * 780 / 1e9, rel=0.01)


def test_serial_is_bytes_bound_at_2_30_ms():
    cell = spec.cell("cohere10m.f1p.serial")
    t, by, _, _ = roofline.for_config(cell.config, 9_900_000, 1)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(2.305, abs=0.005)  # 7.72 GB / 3.35 TB/s


def test_openai5m_f1p_is_bytes_bound_at_4_56_ms():
    cell = spec.cell("openai5m.f1p")
    live = cell.rows - spec.keep_from(cell.mix, cell.rows)  # 4,950,000
    t, by, _, _ = roofline.for_config(cell.config, live, 256)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(4.56, abs=0.01)  # 4.95M x 3,084 B / 3.35 TB/s


def test_peaks_are_the_h100_sxm_data_sheet():
    assert roofline.PEAK_BYTES_S == 3.35e12
    assert roofline.PEAKS == {"bf16": 989e12}
