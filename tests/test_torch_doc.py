"""The port's ``doc`` (``maelstrom_tpu_torch/doc.py``) against the JAX
package's: ``write_docs`` over the port's RPC schema registry (filled by
its ``workloads/``) and error catalog writes ``workloads.md`` and
``protocol.md`` byte-equal to JAX's, and ``doc --out`` prints the JAX
CLI's lines. Every file goes to a temporary directory (never the repo's
own ``doc/``).
"""

import os

from maelstrom_tpu import cli as jcli
from maelstrom_tpu import doc as jdoc
from maelstrom_tpu_torch import __main__ as tcli
from maelstrom_tpu_torch import doc


def _read(paths):
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def test_write_docs_equals_jax(tmp_path):
    got = _read(doc.write_docs(str(tmp_path / "t")))
    want = _read(jdoc.write_docs(str(tmp_path / "j")))
    assert got == want
    assert sorted(got) == ["protocol.md", "workloads.md"]
    assert got["workloads.md"].count(b"\n## ") == 10   # ten namespaces
    assert b"| 20 | key-does-not-exist | yes |" in got["protocol.md"]


def test_doc_renderers_equal_jax():
    assert doc.protocol_md() == jdoc.protocol_md()
    assert doc.workloads_md() == jdoc.workloads_md()


def test_doc_command_prints_jax_s_lines(tmp_path, capsys):
    for cli, name in ((jcli, "j"), (tcli, "t")):
        out = str(tmp_path / name)
        assert cli.main(["doc", "--out", out]) == 0
        assert capsys.readouterr().out == (
            f"wrote {out}/workloads.md\nwrote {out}/protocol.md\n")
    assert _read([tmp_path / "t" / "workloads.md"]) == \
        _read([tmp_path / "j" / "workloads.md"])
