"""The reference on the card against itself on the CPU (marker ``gpu``;
skipped without a card): the benchmark runs the reference on the card."""

import numpy as np
import pytest
import torch

from perfbench.reference.knn import knn
from perfbench.reference.sibson import sibson

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def test_knn_and_sibson_on_the_card(cuda):
    rng = np.random.default_rng(0)
    p = torch.tensor(rng.uniform(0, 30, (20_000, 3)))
    v = torch.tensor(rng.normal(size=(20_000, 3)))
    q = torch.tensor(rng.uniform(0, 30, (5_000, 3)))
    d_cpu, i_cpu, _ = knn(p, q, 50, 6.0)
    d_gpu, i_gpu, _ = knn(p.to(cuda), q.to(cuda), 50, 6.0)
    assert torch.equal(i_gpu.cpu(), i_cpu)
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-13, atol=0)
    torch.testing.assert_close(sibson(p.to(cuda), v.to(cuda), q.to(cuda),
                                      50, 6.0).cpu(),
                               sibson(p, v, q, 50, 6.0), rtol=1e-12,
                               atol=1e-14)
