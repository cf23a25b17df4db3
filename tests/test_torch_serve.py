"""The port's results browser (``maelstrom_tpu_torch/serve.py``) against
the JAX package's (``maelstrom_tpu/serve.py``) on one store tree.

The tree holds every layout the port writes: a process run
(``<workload>/``), a device-runtime run on the CPU (``<workload>-torch/``,
a campaign item's), a native-engine run (``<workload>-native/``) and the
campaign directory with its ``summary.json``. The index, every run page
and the campaign tables are byte-equal to JAX's renderings of the same
tree; one ``ResultsHandler`` on a ``ThreadingHTTPServer`` (port 0, in a
thread, every request with a timeout) serves the same bytes, raw files,
and a 404 for a path out of the store; ``serve`` prints the JAX CLI's
line.
"""

import functools
import http.server
import os
import threading
import urllib.error
import urllib.request

import pytest

from maelstrom_tpu import cli as jcli
from maelstrom_tpu import serve as jserve
from maelstrom_tpu_torch import __main__ as tcli
from maelstrom_tpu_torch import serve
from maelstrom_tpu_torch.campaign import queue, report, runner
from maelstrom_tpu_torch.native.harness import run_native_test
from maelstrom_tpu_torch.runner import run_test

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    import sys
    run_test("echo", dict(bin=sys.executable,
                          bin_args=[os.path.join(REPO, "examples", "python",
                                                 "echo.py")],
                          node_count=1, concurrency=2, rate=20.0,
                          time_limit=1.0, recovery_time=0.2, seed=1,
                          store_root=root))
    run_native_test(dict(workload="g-set", n_instances=16,
                         record_instances=2, time_limit=1.0,
                         nemesis=["partition"], nemesis_interval=0.3,
                         read_prob=0.1, seed=1, threads=1,
                         store_root=root))
    spec = {"name": "serve", "items": [
        {"workload": "echo", "node_count": 1, "n_instances": 4,
         "record_instances": 1, "time_limit": 0.1, "seed": 1}]}
    cdir = queue.submit_campaign(spec, root)
    runner.run_campaign(cdir, device="cpu", log=lambda *a: None)
    report.campaign_report(cdir, static_cost=False)
    return root, cdir


def _runs(root):
    for wl in sorted(os.listdir(root)):
        for run in sorted(os.listdir(os.path.join(root, wl))):
            if os.path.isdir(os.path.join(root, wl, run)):
                yield wl, run


def test_the_tree_holds_every_layout(store):
    root, cdir = store
    names = sorted(os.listdir(root))
    assert names == ["campaigns", "echo", "echo-torch", "g-set-native"]
    assert os.path.exists(os.path.join(cdir, "summary.json"))


def test_index_equals_jax(store):
    root, _ = store
    page = serve._index(root)
    assert page == jserve._index(root)
    for wl, run in _runs(root):
        if run != "latest":
            assert f"href='/{wl}/{run}/'".encode() in page


def test_run_pages_equal_jax(store):
    root, cdir = store
    pages = 0
    for wl, run in _runs(root):
        page = serve._run_page(root, wl, run)
        assert page == jserve._run_page(root, wl, run), (wl, run)
        pages += 1
    assert pages >= 7   # three runs and a campaign, and the latest links
    assert b"<h2>Items</h2>" in serve._run_page(
        root, "campaigns", os.path.basename(cdir))


def test_campaign_tables_equal_jax(store):
    _, cdir = store
    html = serve._campaign_tables(cdir)
    assert html == jserve._campaign_tables(cdir)
    assert "echo-torch/" in html   # the item's run linked in the store
    assert serve._device_phases_cell({}) == jserve._device_phases_cell({})


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def test_handler_serves_the_pages(store):
    root, _ = store
    handler = functools.partial(serve.ResultsHandler, directory=root)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        assert _get(base + "/") == (200, jserve._index(root))
        run = os.path.realpath(os.path.join(root, "g-set-native",
                                            "latest"))
        name = os.path.basename(run)
        assert _get(f"{base}/g-set-native/{name}/") == (
            200, jserve._run_page(root, "g-set-native", name))
        with open(os.path.join(run, "results.json"), "rb") as f:
            assert _get(f"{base}/g-set-native/{name}/results.json") == (
                200, f.read())
        assert _get(f"{base}/g-set-native/..%2F..%2Fetc/")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_command_prints_jax_s_line(monkeypatch, tmp_path, capsys):
    """``serve`` makes the store directory and prints the JAX CLI's line
    (``serve_forever`` stubbed to stop at once)."""
    def stop(self, *a, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever",
                        stop)
    for cli, name in ((jcli, "j"), (tcli, "t")):
        store = str(tmp_path / name)
        assert cli.main(["serve", "--port", "0", "--store", store]) == 0
        assert os.path.isdir(store)
        assert capsys.readouterr().out == (
            f"Serving {store}/ on http://localhost:0\n")
