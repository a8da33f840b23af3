"""Every "not ported" error of the port names the module that brings the
feature, never a queue number of ROADMAP.md: the queues are renumbered each
time the roadmap is rewritten, so a number goes stale where a name does not.
"""

import re

import numpy as np
import pytest
import torch

from local_search_quantization_torch.index import Index

torch.set_num_threads(1)

QUEUE_NUMBER = re.compile(r"queue\w*\s*\d", re.IGNORECASE)


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    xt = rng.normal(size=(200, 8)).astype(np.float32)
    return Index.build(xt, xt[:120], "pq", m=2, h=8, niter=1, seed=0, device="cpu")


CASES = {
    "search(mesh=)": lambda ix, tmp: ix.search(np.zeros((1, 8), np.float32), k=3,
                                               mesh=object()),
}
MODULES = {"search(mesh=)": "parallel/"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_not_ported_errors_name_a_module_and_no_queue_number(case, index, tmp_path):
    with pytest.raises(NotImplementedError) as err:
        CASES[case](index, tmp_path)
    msg = str(err.value)
    assert "not ported" in msg and "ROADMAP.md" in msg
    assert f"module {MODULES[case]}" in msg, msg
    assert not QUEUE_NUMBER.search(msg), msg
