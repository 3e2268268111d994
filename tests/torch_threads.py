"""The port tests' thread pin: one intra-op thread for a test file's
PyTorch work. The suite runs six workers on the machine's cores, and
eight threads a worker oversubscribe them; runs held to other runs bit for
bit need one thread as well (``tests/test_torch_resume.py``). A test file
takes it with

    from torch_threads import one_thread  # noqa: F401 (autouse fixture)
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
