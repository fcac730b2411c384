"""CPU budget of the port's test modules.

The suite runs several pytest workers on a few cores, so CPU one test
wastes is time the other workers' tests lose:

- ``one_torch_thread``: at torch's default of one intra-op thread a core,
  the small CPU forwards of the port's tests spend most of their CPU time
  in threads waiting on each other.  A module that imports the fixture
  runs its tests on one thread and restores the count after them.
- ``USE_TF=0``: ``transformers`` otherwise imports TensorFlow, which no
  test uses, in every worker that collects a module importing it.  Set on
  import of this module, which the port's test modules import at
  collection.
"""

import os

import pytest
import torch

os.environ.setdefault("USE_TF", "0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
