"""The output check catches what a broken timed path would produce. Each
test skips the harness's look for a card and drives the rest of a run on
the CPU at a small size, with the program's timed path broken underneath,
and reads ``correct`` off the result line."""

import argparse
import json
import threading
import time

import numpy as np
import pytest
import torch

from bench_torch import launcher, run
from bench_torch.runners import serve, ssl_train

CPU = torch.device("cpu")


def drive(files, workload, tmp_path, capsys, seed=2 ** 31 + 77, seconds=3.0):
    runner = ssl_train if files["model"]["runner"] == "ssl_train" else serve
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=0)
    out = runner.run(args, files, tmp_path, time.perf_counter(), CPU)
    capsys.readouterr()
    run.report(args, files, out)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_ssl_sound_run_is_correct(tiny, tmp_path, capsys):
    assert drive(tiny("ssl_cli"), "ssl_cli", tmp_path, capsys)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_ssl_fault_is_caught(fault, tiny, tmp_path, capsys, monkeypatch):
    from lafs_cvpr2024_tpu_torch.train import ssl

    make = ssl.make_ssl_train_step

    def broken(cfg):
        step = make(cfg)

        def faulty(state, landmark, images, *rest, **kw):
            if fault == "half_batch":
                return step(state, landmark, images[: images.shape[0] // 2],
                            *rest, **kw)
            _, metrics = step(state, landmark, images, *rest, **kw)
            return state, metrics

        faulty.__dict__.update(step.__dict__)
        return faulty

    monkeypatch.setattr(ssl, "make_ssl_train_step", broken)
    line = drive(tiny("ssl_cli"), "ssl_cli", tmp_path, capsys)
    assert line["correct"] is False


class _InProcess:
    """The launcher run in a thread of this process, as a Popen would be."""

    def __init__(self, cmd):
        self.returncode = None
        argv = cmd[2:]
        self.thread = threading.Thread(target=self._main, args=(argv,))
        self.thread.start()

    def _main(self, argv):
        self.returncode = launcher.main(argv)

    def wait(self, timeout=None):
        self.thread.join(timeout)
        return self.returncode

    def poll(self):
        return None if self.thread.is_alive() else self.returncode

    def kill(self):
        pass


@pytest.mark.parametrize("workload", ["serve_gallery", "serve_camera"])
@pytest.mark.parametrize("fault", [None, "answer_altered"])
def test_serve_answers_are_checked(workload, fault, tiny, tmp_path, capsys,
                                   monkeypatch):
    from lafs_cvpr2024_tpu_torch.cli import serve_embeddings as srv

    monkeypatch.chdir(tmp_path)  # the server's socket path is relative
    monkeypatch.setattr(serve.subprocess, "Popen",
                        lambda cmd, **kw: _InProcess(cmd))
    if fault:
        collect = srv.EmbeddingServer._collect

        def altered(self, handles):
            e = np.array(collect(self, handles))
            e[0] = -e[0]  # one answer of every reply
            return e

        monkeypatch.setattr(srv.EmbeddingServer, "_collect", altered)
    line = drive(tiny(workload), workload, tmp_path, capsys)
    assert line["correct"] is (fault is None)
    assert line["failed"] == 0 and line["attempted"] > 0
