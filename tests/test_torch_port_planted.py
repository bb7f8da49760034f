"""``chip_smoke.py``'s planted faults against the sources they edit, on the
CPU.

``python3 chip_smoke.py --planted-faults`` copies the port once for each
entry of ``chip_smoke.PLANTED_FAULTS``, replaces one text in one file (a
kernel source, or for ``dp`` the data-parallel step) and
reads the copy's ``--parity`` readings on the card (``bf16``: the mixed
precision paths', ``dgcnn``: phase 10's DGCNN); it raises when the text
does not occur exactly once. Here every entry's text is held to its file, so
that a redesign which removes or duplicates a planted line fails in the
CPU tests and not only on the card.
"""

import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)

import chip_smoke  # noqa: E402

REPO = Path(chip_smoke.__file__).resolve().parent
FAULTS = sorted(name for name, fault in chip_smoke.PLANTED_FAULTS.items() if fault is not None)


@pytest.mark.parametrize("name", FAULTS)
def test_planted_fault_text_occurs_once(name):
    path, file, old, new = chip_smoke.PLANTED_FAULTS[name]
    assert path in ("partseg", "semseg", "repsurf", "dp", "bf16", "dgcnn"), path
    assert file.startswith("mpa_tpu_torch/"), file  # the copies hold the port only
    text = (REPO / file).read_text()
    assert text.count(old) == 1, f"{name!r}: {old!r} occurs {text.count(old)} times in {file}"
    assert new != old


def test_every_parity_path_has_a_planted_fault():
    paths = {fault[0] for fault in chip_smoke.PLANTED_FAULTS.values() if fault is not None}
    assert paths == {"partseg", "semseg", "repsurf", "dp", "bf16", "dgcnn"}
    assert chip_smoke.PLANTED_FAULTS["none"] is None
