"""Minimal interactive alignment surface — the framework's equivalent of
the reference's browser engine (/root/reference/SmithWaterman.html:384-415).

The reference ships a standalone HTML page: two multi-FASTA textareas
aligned all-vs-all, user-settable gap penalties (html:396-397), a
BLOSUM62-vs-match/mismatch(4,-1) selector (html:62-69), and a `:` match
line in the result (html:364-371).  Ours serves the same surface from a
stdlib HTTP server backed by the real engine (scan on CPU, the CUDA fill
on a GPU via the Aligner routing):

    python -m smithwaterman_tpu.web [--port 8000]

GET /        — the page (vanilla HTML+JS, no dependencies)
POST /align  — JSON {seq1, seq2, gap_open, gap_extend, matrix} ->
               {results: [{name1, name2, aligned1, match, aligned2,
                           score}], warnings: [...]}
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .aligner import Aligner
from .config import LOCAL, AlignConfig
from .io.fasta import SeqData, parse_fasta
from .matrices import SubstitutionMatrix
from .utils.display import match_line

PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>smithwaterman_tpu</title>
<style>
 body { font-family: sans-serif; margin: 2em; max-width: 60em; }
 textarea { width: 100%; font-family: monospace; }
 pre { background: #f4f4f4; padding: 1em; overflow-x: auto; }
 .err { color: #b00; }
</style></head><body>
<h2>smithwaterman_tpu <small>(interactive)</small></h2>
<p>Multi-FASTA in both boxes &rarr; all-vs-all local alignment.</p>
<textarea id="s1" rows="6">&gt;query\nHEAGAWGHEE</textarea><br>
<textarea id="s2" rows="6">&gt;subject\nPAWHEAE</textarea><br>
<p>
 Gap Open Penalty: <input id="go" value="10" size="5">
 Gap Extend Penalty: <input id="ge" value="0.5" size="5"><br>
 <label><input type="radio" name="mat" value="protein" checked>BLOSUM62</label>
 <label><input type="radio" name="mat" value="lettermatch">Match:4,Mismatch:-1</label><br>
 <button onclick="run()">Calculate</button>
</p>
<pre id="out"></pre><div id="msg" class="err"></div>
<script>
async function run() {
  const body = {
    seq1: document.getElementById('s1').value,
    seq2: document.getElementById('s2').value,
    gap_open: parseFloat(document.getElementById('go').value),
    gap_extend: parseFloat(document.getElementById('ge').value),
    matrix: document.querySelector('input[name=mat]:checked').value,
  };
  document.getElementById('msg').textContent = '';
  try {
    const r = await fetch('/align', {method: 'POST', body: JSON.stringify(body)});
    const d = await r.json();
    if (d.error) { document.getElementById('msg').textContent = d.error; return; }
    let t = '';
    for (const a of d.results) {
      t += '>' + a.name1 + ' vs ' + a.name2 + '  score: ' + a.score + '\\n'
        + a.aligned1 + '\\n' + a.match + '\\n' + a.aligned2 + '\\n\\n';
    }
    document.getElementById('out').textContent = t;
    document.getElementById('msg').textContent = (d.warnings || []).join(' ');
  } catch (e) { document.getElementById('msg').textContent = String(e); }
}
</script></body></html>
"""


def align_request(req: dict) -> dict:
    """Handle one /align request dict; pure function for tests."""
    try:
        go = float(req.get("gap_open", 10.0))
        ge = float(req.get("gap_extend", 0.5))
    except (TypeError, ValueError):
        return {"error": "penalties must be numbers"}
    if req.get("matrix") == "lettermatch":
        # the JS engine's DNA/letter mode: match 4, mismatch -1 (html:62-69)
        sm = SubstitutionMatrix.match_mismatch(4.0, -1.0)
    else:
        sm = SubstitutionMatrix.blosum62()
    cfg = AlignConfig(mode=LOCAL, gap_open=go, gap_extend=ge)
    engine = Aligner(scoring_matrix=sm, config=cfg)

    recs1 = parse_fasta(str(req.get("seq1", "")).splitlines())
    recs2 = parse_fasta(str(req.get("seq2", "")).splitlines())
    if not recs1:
        recs1 = [SeqData("seq1", "", str(req.get("seq1", "")).strip())]
    if not recs2:
        recs2 = [SeqData("seq2", "", str(req.get("seq2", "")).strip())]
    results = []
    # all-vs-all over both textareas, like the JS engine (html:123-135)
    for s1 in recs1:
        for s2 in recs2:
            r = engine.align(s1, s2, True)
            results.append(
                {
                    "name1": s1.name or "seq1",
                    "name2": s2.name or "seq2",
                    "aligned1": r.aligned1,
                    "match": match_line(r.aligned1, r.aligned2),
                    "aligned2": r.aligned2,
                    "score": r.score,
                }
            )
    return {"results": results, "warnings": []}


class Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path in ("/", "/index.html"):
            self._send(200, PAGE.encode(), "text/html; charset=utf-8")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802
        if self.path != "/align":
            self._send(404, b"not found", "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            out = align_request(req)
        except Exception as e:  # surface errors to the page, don't 500
            out = {"error": f"{type(e).__name__}: {e}"}
        self._send(200, json.dumps(out).encode(), "application/json")

    def log_message(self, fmt, *args):  # quiet
        pass


def serve(port: int = 8000, host: str = "127.0.0.1") -> None:
    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"smithwaterman_tpu web UI on http://{host}:{port}/", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    a = ap.parse_args()
    serve(a.port, a.host)
