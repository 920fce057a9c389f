"""A module-scoped fixture that runs a test module's torch ops on one
intra-op thread.

The codec tests run thousands of small torch ops in loops (the plain Huffman
decoder's 4096 steps, the LZ block scan). Under the suite's parallel workers
each op's thread team would contend with every other worker's; one thread
per worker keeps them from oversubscribing the CPU. Import it into a test
module to apply it there.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
