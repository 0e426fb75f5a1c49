"""The output check's control (the plain reference one precision below the
configuration's, in the program's place) comes out as not correct under
each cell's committed limits, here at a CPU test's size; its readings at
the cells' own sizes on the card are in ``limits/<workload>.json``."""

import pytest
import torch

from bench_torch import control

CPU = torch.device("cpu")


def test_ssl_control_fails_a_limit(tiny):
    files = tiny("ssl_cli")
    r = control.ssl_readings(files, 2 ** 31 + 11, CPU)
    lim = files["limits"]
    assert any(r["control"][k] > lim[k] for k in lim)
    assert any(r["half_batch"][k] > lim[k] for k in lim)


@pytest.mark.parametrize("workload", ["serve_gallery", "serve_camera"])
def test_serve_control_fails_the_limit(workload, tiny):
    files = tiny(workload)
    r = control.serve_readings(files, 2 ** 31 + 12, CPU, 2.0)
    assert r["control"]["embed_err"] > files["limits"]["embed_err"]
