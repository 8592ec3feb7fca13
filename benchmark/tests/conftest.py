"""The benchmark's own tests.  Those marked ``cuda`` run on the card and
skip elsewhere; whether there is a card is decided inside the ``card``
fixture, never while a module is imported.

    python3 -m pytest -q benchmark/tests            # CPU, ~1 min
    python3 -m pytest -q -m cuda benchmark/tests    # on the card
"""

import json
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cell(limits_of: str = "sr3_16_128.serve_b8", **traffic) -> dict:
    """A cell at a CPU test size: the tiny config, the serve_b8 traffic cut
    to requests of 2 or 3 faces, chunks of 2 and 5 DDIM steps, held to the
    limits of ``limits_of``."""
    from benchmark import spec

    t = spec.load_json(spec.HERE / "traffic" / "serve_b8.json")
    t.update(request_faces=[2, 3], batch_size=2, faces_pool=8,
             check_requests=2, warmup_requests=1, trace_requests=1)
    t["serve"] = dict(t["serve"], steps=5)
    t.update(traffic)
    return {"workload": {"name": "tiny.serve_b8", "chips": 1},
            "config": json.loads((HERE / "tiny_config.json").read_text()),
            "traffic": t,
            "limits": spec.load_json(spec.HERE / "limits"
                                     / f"{limits_of}.json"),
            "end_to_end": [{"name": "faces_per_s", "unit": "faces/s"},
                           {"name": "request_p90_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "unet.host_ms_per_call", "unit": "ms"}]}
