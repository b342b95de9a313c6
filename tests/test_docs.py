"""Docs are executable: every ```python block in docs/*.md runs under
pytest, notebook-style (blocks of one file share a namespace, in order).

The reference makes its docs executable by authoring every source file as
a jupytext notebook built by Jupyter-Book (docs/_config.yml:96-99); here
the prose stays markdown and this runner is the CI teeth — a broken doc
snippet fails the suite.

Blocks fenced as ```python noexec are skipped (none currently).
"""

import pathlib
import re

import pytest

DOCS = pathlib.Path(__file__).resolve().parent.parent / "docs"
_BLOCK = re.compile(r"^```python[ \t]*(\S*)\s*\n(.*?)^```\s*$",
                    re.M | re.S)


def _blocks(path: pathlib.Path):
    text = path.read_text()
    out = []
    for m in _BLOCK.finditer(text):
        tag, code = m.group(1), m.group(2)
        line = text[: m.start()].count("\n") + 2
        if tag != "noexec":
            out.append((line, code))
    return out


_FILES = sorted(p.name for p in DOCS.glob("*.md") if _blocks(p))


@pytest.mark.parametrize("name", _FILES)
def test_doc_code_blocks_execute(name):
    path = DOCS / name
    ns = {"__name__": f"docs.{path.stem}"}
    for line, code in _blocks(path):
        try:
            exec(compile(code, f"{path}:{line}", "exec"), ns)
        except Exception as e:  # pragma: no cover - failure reporting
            pytest.fail(
                f"{path.name} code block at line {line} failed: "
                f"{type(e).__name__}: {e}"
            )


def test_docs_have_blocks():
    # the runner must actually be running something
    assert "getting_started.md" in _FILES
    assert "migrating.md" in _FILES
