"""The port's test processes run torch on one intra-op thread
(``tests/torch_harness.py``)."""
import torch_harness  # noqa: F401

import torch


def test_a_port_test_process_runs_torch_on_one_thread():
    assert torch.get_num_threads() == 1
