"""The port's hazard linter (``repro_torch.analysis.lint``) and its CLI.

For each rule a snippet that must be flagged and its clean counterpart,
written to ``tmp_path`` (under ``kernels/``, ``core/`` or ``models/``
where the rule reads only those trees); ``# noqa`` and ``# noqa: RT00x``
(``// noqa`` in CUDA) suppression; the port's own tree linting clean; and
``python -m repro_torch.analysis``: exit 0 on the tree, 1 on a finding,
the JSON report, the ``--rules`` table, and no ``jax`` / ``repro``
import.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.__main__ import main as cli

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

CAPTURED = '''
    import torch
    from repro_torch.core.pipeline.step_pipeline import StepFns

    def finish(state, ctx):
        {body}
        return state

    fns = StepFns(begin=None, force=None, finish=finish, reduce=None)
'''

# rule -> (tree, flagged snippet, clean snippet)
CASES = {
    "RT001": ("", CAPTURED.format(body="n = state.sum().item()"),
              CAPTURED.format(body="n = state.sum()")),
    "RT001-int": ("", CAPTURED.format(body="n = int(torch.sum(state))"),
                  CAPTURED.format(body="n = int(state.shape[0])")),
    "RT001-sync": ("", CAPTURED.format(body="torch.cuda.synchronize()"),
                   CAPTURED.format(body="state = state + 1")),
    "RT001-function": ("", '''
        import torch

        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * float(x.max())

            @staticmethod
            def backward(ctx, g):
                return g
        ''', '''
        import torch

        def host_driver(x):
            return x * float(x.max())
        '''),
    "RT001-graph": ("", '''
        import torch

        def step(x):
            return x.cpu()

        def capture(g, x):
            with torch.cuda.graph(g):
                step(x)
        ''', '''
        import torch

        def step(x):
            return x.cpu()

        def run(x):
            step(x)
        '''),
    "RT002": ("", CAPTURED.format(
        body="state = state + torch.tensor([1.0], device=state.device)"),
        CAPTURED.format(body="state = state + ctx['one']")),
    "RT003": ("", CAPTURED.format(body="print(state.shape)"),
              CAPTURED.format(body="state = state * 2")),
    "RT004": ("kernels", '''
        import torch

        def table(n, device):
            return torch.zeros(n, device=device)
        ''', '''
        import torch

        def table(n, device):
            return torch.zeros(n, dtype=torch.int32, device=device)
        '''),
    "RT005": ("core", '''
        def mean(x, n):
            return x.sum() / float(n)
        ''', '''
        from repro_torch.device import const

        def mean(x, n):
            return x.sum() / const(float(n), x.dtype, x.device)
        '''),
    "RT006": ("models", '''
        def embed(table, idx):
            return table.index_select(0, idx)
        ''', '''
        def embed(table, idx):
            return _GatherRows.apply(table, idx)
        '''),
    "RT006-accumulate": ("core", '''
        def histogram(out, idx, w):
            return out.index_put_((idx,), w, accumulate=True)
        ''', '''
        def histogram(out, idx, w):
            return out.index_put_((idx,), w)
        '''),
    "RT006-indexing": ("models", '''
        import torch

        def pick(x, key):
            order = torch.argsort(key)
            return x[order]
        ''', '''
        import torch

        def pick(x, k):
            n = int(k)
            return x[n]
        '''),
    "RT007": ("", '''
        import time
        import torch

        def bench(model, batch):
            t0 = time.perf_counter()
            loss = model.loss_fn(batch)
            return time.perf_counter() - t0
        ''', '''
        import time
        import torch

        def bench(model, batch):
            t0 = time.perf_counter()
            loss = model.loss_fn(batch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        '''),
    "RT008": ("", '''
        def restore(load):
            try:
                return load()
            except Exception:
                return None
        ''', '''
        import warnings

        def restore(load):
            try:
                return load()
            except Exception as e:
                warnings.warn(f"restore failed: {e}")
                return None
        '''),
}

CUDA_FLAGGED = '''
    __global__ void k(float* x) { x[threadIdx.x] = 0.f; }

    template <int N>
    void launch(float* x, cudaStream_t s) {
      k<<<1, N, 0, s>>>(x);   /* no error read here */
    }

    extern "C" int entry(float* x, void* s) {
      launch<32>(x, static_cast<cudaStream_t>(s));
      return 0;
    }
'''
CUDA_CLEAN = CUDA_FLAGGED.replace(
    "return 0;", "return static_cast<int>(cudaGetLastError());")


def _write(tmp_path, tree, source, name="mod.py"):
    path = tmp_path / tree / name if tree else tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def _codes(path):
    return [d.code for d in lint.lint_file(str(path))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_flags_its_snippet_and_not_the_clean_one(tmp_path, case):
    tree, bad, good = CASES[case]
    code = case.split("-")[0]
    bad_path = _write(tmp_path, tree, bad)
    assert code in _codes(bad_path)
    assert code not in _codes(_write(tmp_path / "clean", tree, good))
    assert cli([str(bad_path), "--no-verify"]) == 1


def test_path_scoped_rules_read_only_their_trees(tmp_path):
    for case in ("RT004", "RT005", "RT006"):
        _, bad, _ = CASES[case]
        assert case not in _codes(_write(tmp_path / case, "launch", bad))


def test_cuda_rule_follows_helpers_to_the_entry(tmp_path):
    bad = _write(tmp_path, "csrc", CUDA_FLAGGED, "k.cu")
    diags = lint.lint_file(str(bad))
    assert [d.code for d in diags] == ["RT009"]
    assert cli([str(bad), "--no-verify"]) == 1
    assert "launch<32>" in bad.read_text().splitlines()[diags[0].line - 1]
    good = _write(tmp_path / "clean", "csrc", CUDA_CLEAN, "k.cu")
    assert _codes(good) == []
    direct = """
        __global__ void k(float* x) { x[threadIdx.x] = 0.f; }

        extern "C" int entry(float* x) {
          k<<<1, 32>>>(x);
          if (cudaPeekAtLastError() != cudaSuccess) return 1;
          k<<<1, 32>>>(x);
          return static_cast<int>(cudaGetLastError());
        }
    """
    assert _codes(_write(tmp_path / "direct", "csrc", direct, "k.cu")) == []
    unread = direct.replace("return static_cast<int>(cudaGetLastError());",
                            "return 0;")
    assert _codes(_write(tmp_path / "unread", "csrc", unread, "k.cu")) == \
        ["RT009"]


def test_noqa_suppresses_all_or_the_named_codes(tmp_path):
    _, bad, _ = CASES["RT005"]
    line = "    return x.sum() / float(n)"
    for tail, flagged in (("  # noqa", False), ("  # noqa: RT005 - why",
                                                 False),
                          ("  # noqa: RT006", True)):
        src = textwrap.dedent(bad).replace(line.strip(),
                                           line.strip() + tail)
        path = _write(tmp_path / tail.strip("# :-").replace(" ", "_"),
                      "core", src)
        assert ("RT005" in _codes(path)) == flagged, tail
    cu = CUDA_FLAGGED.replace("launch<32>(x, static_cast<cudaStream_t>(s));",
                              "launch<32>(x, static_cast<cudaStream_t>(s));"
                              "  // noqa: RT009")
    assert _codes(_write(tmp_path / "cu", "csrc", cu, "k.cu")) == []


def test_the_port_lints_clean():
    diags, n_files = lint.lint_paths([str(PORT)])
    assert n_files > 80
    assert any(f.suffix == ".cu" for f in lint.iter_source_files([str(PORT)]))
    assert diags == [], "\n".join(d.format() for d in diags)


def test_cli_exit_codes_and_report(tmp_path, capsys):
    report = tmp_path / "out" / "report.json"
    assert cli(["--no-verify", "--report", str(report)]) == 0
    rep = json.loads(report.read_text())
    assert rep["lint"]["n_findings"] == 0 and rep["verifier"] is None
    assert set(rep["lint"]["rules"]) == set(lint.RULES)
    bad = _write(tmp_path, "core", CASES["RT005"][1])
    assert cli([str(bad), "--no-verify", "--report", str(report)]) == 1
    rep = json.loads(report.read_text())
    assert [f["code"] for f in rep["lint"]["findings"]] == ["RT005"]
    assert "RT005 [float-divisor]" in capsys.readouterr().out
    assert cli(["--rules"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert [row.split()[0] for row in table] == sorted(lint.RULES)


def test_cli_runs_both_layers_with_jax_blocked(tmp_path):
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import runpy\n"
            "sys.argv = ['repro_torch.analysis', '--report', sys.argv[1]]\n"
            "runpy.run_module('repro_torch.analysis', run_name='__main__')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    report = tmp_path / "report.json"
    proc = subprocess.run([sys.executable, "-c", code, str(report)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(report.read_text())
    assert rep["lint"]["n_findings"] == 0
    assert rep["verifier"]["all_safe"] and rep["verifier"]["n_configs"] == 58
