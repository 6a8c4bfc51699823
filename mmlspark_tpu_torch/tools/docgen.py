"""API documentation generator over the port — the port of the repo's
``tools/docgen.py`` (the JAX package's).

Docs generate straight from the port's live registries: every registered
pipeline stage's docstring and param table (one .rst page per stage
module), every registered model builder (``models.rst``) and an index;
:func:`render_html` converts that .rst subset into a static HTML site
(no sphinx needed). The pages and param tables equal the JAX package's,
but for the ``device`` param the port's stages declare.

The default output is ``build/docs_torch/api`` with the HTML in
``build/docs_torch/html`` (``build/`` is not committed): the JAX
package's committed ``docs/api`` and ``docs/html`` are never written.

Usage: python -m mmlspark_tpu_torch docgen [output_dir]
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

from mmlspark_tpu_torch.tools.common import REPO

#: where the .rst pages go by default; the HTML goes to ``../html``
DEFAULT_OUT = str(REPO / "build" / "docs_torch" / "api")


def _import_all() -> None:
    # importing the packages populates the registries
    import mmlspark_tpu_torch.data.readers  # noqa: F401
    import mmlspark_tpu_torch.models  # noqa: F401
    import mmlspark_tpu_torch.stages  # noqa: F401


def _underline(text: str, ch: str) -> str:
    return f"{text}\n{ch * len(text)}\n"


def _param_table(cls) -> list[str]:
    rows = []
    for name, p in sorted(cls.params().items()):
        default = "required" if p.required else repr(p.get_default())
        domain = " | ".join(p.domain) if p.domain else ""
        doc = (p.doc or "").replace("\n", " ")
        rows.append((name, default, domain, doc))
    if not rows:
        return ["(no parameters)", ""]
    widths = [max(len(r[i]) for r in rows + [_HDR]) for i in range(4)]

    def fmt(r):
        return "  ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip()

    sep = tuple("=" * w for w in widths)
    return [fmt(sep), fmt(_HDR), fmt(sep), *(fmt(r) for r in rows),
            fmt(sep), ""]


_HDR = ("param", "default", "domain", "doc")


def generate(out_dir: str) -> list[str]:
    """Write one .rst per stage module + models.rst + index.rst; returns
    the written paths."""
    from mmlspark_tpu_torch.core.stage import PipelineStage
    from mmlspark_tpu_torch.models.registry import registered_models

    _import_all()
    os.makedirs(out_dir, exist_ok=True)
    by_module: dict[str, list[type]] = defaultdict(list)
    for name, cls in sorted(PipelineStage.registry().items()):
        mod = cls.__module__.rsplit(".", 1)[-1]
        by_module[mod].append(cls)

    written = []
    for mod, classes in sorted(by_module.items()):
        lines = [_underline(mod, "="), ""]
        for cls in classes:
            lines.append(_underline(cls.__name__, "-"))
            # own docstring, else the module overview (many stage classes
            # document the family at module level, like the reference's
            # colocated .txt doc files)
            doc = cls.__dict__.get("__doc__")
            if not doc:
                module = sys.modules.get(cls.__module__)
                mod_doc = (module.__doc__ or "") if module else ""
                doc = mod_doc.split("\n\n")[0] or "(undocumented)"
            lines.append(doc.strip())
            lines.append("")
            lines.extend(_param_table(cls))
        path = os.path.join(out_dir, f"{mod}.rst")
        with open(path, "w") as f:
            f.write("\n".join(lines))
        written.append(path)

    # model registry page
    lines = [_underline("models", "="), "",
             "Registered model architectures (``build_model`` names):", ""]
    for name in registered_models():
        from mmlspark_tpu_torch.models.registry import _BUILDERS

        fn = _BUILDERS[name]
        doc = (fn.__doc__ or "(undocumented)").strip().replace("\n", " ")
        lines.append(f"``{name}``")
        lines.append(f"    {doc}")
        lines.append("")
    path = os.path.join(out_dir, "models.rst")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    written.append(path)

    # index
    entries = "\n".join(
        f"   {os.path.splitext(os.path.basename(p))[0]}" for p in written
    )
    index = os.path.join(out_dir, "index.rst")
    with open(index, "w") as f:
        f.write(
            _underline("API reference", "=")
            + "\n.. toctree::\n   :maxdepth: 1\n\n"
            + entries + "\n"
        )
    written.append(index)
    return written


# -- HTML assembly -----------------------------------------------------------
#
# The reference assembles its generated .rst with a sphinx build
# (tools/pydocs). This image has neither sphinx nor docutils and no
# egress, so render_html() converts the exact .rst subset generate()
# emits (titles, sections, paragraphs, literals, simple-format tables)
# into a static HTML site; docs/conf.py remains for sphinx-equipped
# environments.

_CSS = """body{font-family:sans-serif;max-width:60em;margin:2em auto;
padding:0 1em;color:#222}table{border-collapse:collapse;margin:1em 0}
td,th{border:1px solid #bbb;padding:.3em .6em;text-align:left;
font-size:.9em}th{background:#eee}code{background:#f4f4f4;
padding:0 .2em}h1{border-bottom:2px solid #444}h2{color:#334}"""


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _inline(s: str) -> str:
    import re

    return re.sub(r"``([^`]*)``", r"<code>\1</code>", _esc(s))


def _rst_to_html(text: str, title: str, pages: set[str] = frozenset()) -> str:
    lines = text.splitlines()
    out = [f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<title>{_esc(title)}</title><style>{_CSS}</style></head><body>"]
    i = 0
    while i < len(lines):
        line = lines[i]
        nxt = lines[i + 1] if i + 1 < len(lines) else ""
        if nxt and set(nxt.strip()) == {"="} and len(nxt) >= len(line) > 0:
            out.append(f"<h1>{_inline(line)}</h1>")
            i += 2
        elif nxt and set(nxt.strip()) == {"-"} and len(nxt) >= len(line) > 0:
            out.append(f"<h2>{_inline(line)}</h2>")
            i += 2
        elif (line.strip() and set(line.strip()) <= {"=", " "}
              and " " in line.strip()):
            # simple-format table: border, header, border, rows..., border
            cols, start = [], 0
            for seg in line.split():
                begin = line.index(seg, start)
                cols.append((begin, begin + len(seg)))
                start = begin + len(seg)
            cols[-1] = (cols[-1][0], 10 ** 6)

            def cells(row):
                return [row[a:b].strip() for a, b in cols]

            header = cells(lines[i + 1])
            out.append("<table><tr>" + "".join(
                f"<th>{_inline(c)}</th>" for c in header) + "</tr>")
            j = i + 3
            def _is_border(row):
                st = row.strip()
                return st and set(st) <= {"=", " "}

            while j < len(lines) and not _is_border(lines[j]):
                out.append("<tr>" + "".join(
                    f"<td>{_inline(c)}</td>" for c in cells(lines[j])
                ) + "</tr>")
                j += 1
            out.append("</table>")
            i = j + 1
        elif line.startswith(".. toctree::"):
            i += 1  # directive; options/entries handled as links below
        elif line.strip().startswith(":"):
            i += 1  # directive option
        elif line.startswith("   ") and line.strip() in pages:
            name = line.strip()
            out.append(f"<p><a href='{name}.html'>{_esc(name)}</a></p>")
            i += 1
        elif line.startswith("   ") and line.strip():
            out.append(f"<p style='margin-left:2em'>{_inline(line)}</p>")
            i += 1
        elif line.strip():
            out.append(f"<p>{_inline(line)}</p>")
            i += 1
        else:
            i += 1
    out.append("</body></html>")
    return "\n".join(out)


def render_html(rst_dir: str, out_dir: str) -> list[str]:
    """Static HTML site from the generated .rst tree."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    pages = {os.path.splitext(f)[0] for f in os.listdir(rst_dir)
             if f.endswith(".rst")}
    for fname in sorted(os.listdir(rst_dir)):
        if not fname.endswith(".rst"):
            continue
        base = os.path.splitext(fname)[0]
        with open(os.path.join(rst_dir, fname)) as f:
            html = _rst_to_html(f.read(), base, pages)
        path = os.path.join(out_dir, f"{base}.html")
        with open(path, "w") as f:
            f.write(html)
        written.append(path)
    return written


def main(argv: list[str] | None = None) -> int:
    """Write the .rst pages to ``argv[0]`` (default :data:`DEFAULT_OUT`)
    and the HTML beside them, in ``html``."""
    args = list(sys.argv[1:] if argv is None else argv)
    out = args[0] if args else DEFAULT_OUT
    paths = generate(out)
    html = render_html(out, os.path.join(os.path.dirname(out) or ".",
                                         "html"))
    print(f"wrote {len(paths)} rst + {len(html)} html files under "
          f"{os.path.dirname(out) or '.'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
