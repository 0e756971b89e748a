"""Package rules of the PyTorch port: no JAX anywhere in it or in
``chip_smoke.py`` (nor flax's ``msgpack`` and ``ml_dtypes``, which the
card's machine lacks), entry points that refuse to fall back to the CPU,
kernels that stay unlaunched on CPU tensors, and a package surface -- every
subpackage's exports, the ``Engine`` signature -- that matches the JAX
package's but for the names it leaves out on purpose."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from context_attentive_ir_tpu_torch.config import default_config
from context_attentive_ir_tpu_torch.data import Dictionary
from context_attentive_ir_tpu_torch.models.multitask.cars import CARS
from context_attentive_ir_tpu_torch.ops.kernels import beamgen, lstm
from context_attentive_ir_tpu_torch.serve import Engine

ROOT = Path(__file__).resolve().parent.parent
BANNED_ROOTS = {"jax", "flax", "optax", "msgpack", "ml_dtypes"}
JAX_PACKAGE = "context_attentive_ir_tpu"


def _banned(module: str) -> bool:
    """True for jax/flax/optax/msgpack/ml_dtypes and for the JAX package
    itself -- matched as a module path, so
    ``context_attentive_ir_tpu_torch`` passes."""
    return (module.split(".")[0] in BANNED_ROOTS or module == JAX_PACKAGE
            or module.startswith(JAX_PACKAGE + "."))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    files = sorted((ROOT / "context_attentive_ir_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_banned_matcher_is_exact():
    assert _banned("jax.numpy") and _banned("flax") and _banned("optax")
    assert _banned("msgpack") and _banned("ml_dtypes")
    assert _banned("context_attentive_ir_tpu")
    assert _banned("context_attentive_ir_tpu.ops.rnn")
    assert not _banned("context_attentive_ir_tpu_torch.ops.rnn")
    assert not _banned("jaxlib_free_name") and not _banned("torch")


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _banned(m)]
    assert not bad, bad


def _tiny():
    cfg = default_config("cars").replace(
        vocab_size=40, emsize=8, nhid=4, nhid_ffnn=8, max_query_len=5,
        max_doc_len=6, max_session_len=2, num_candidates=4, dropout=0.0,
        dropout_emb=0.0, dropout_rnn=0.0)
    wd = Dictionary()
    for k in range(cfg.vocab_size - len(wd)):
        wd.add(f"w{k}")
    return cfg, wd


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, wd = _tiny()
    params = CARS(cfg, device="cpu").state_dict()
    x = torch.zeros(2, 3, 4)
    mask = torch.ones(2, 3, dtype=torch.bool)
    for call in (lambda: Engine(cfg, wd, params),
                 lambda: CARS(cfg),
                 lambda: lstm.lstm_fused(x, mask, torch.zeros(4, 8),
                                         torch.zeros(8), torch.zeros(2, 8)),
                 lambda: beamgen.generator_topk_lse(torch.zeros(2, 4),
                                                    torch.zeros(4, 9), 2)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_cuda_request_never_runs_cpu_tensors(monkeypatch):
    """With a card present, CPU tensors handed to a CUDA wrapper raise
    instead of silently taking the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    x = torch.zeros(2, 3, 4)
    mask = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="device"):
        lstm.lstm_fused(x, mask, torch.zeros(4, 8), torch.zeros(8),
                        torch.zeros(2, 8))
    with pytest.raises(ValueError, match="device"):
        beamgen.generator_topk_lse(torch.zeros(2, 4), torch.zeros(4, 9), 2)


def test_kernels_unlaunched_on_cpu(monkeypatch):
    """The whole CPU path (rank, beam and greedy suggest) takes the plain
    versions: the launch counts stay 0."""
    monkeypatch.setattr(lstm.lstm_fused, "launches", 0)
    monkeypatch.setattr(beamgen.generator_topk_lse, "launches", 0)
    cfg, wd = _tiny()
    params = CARS(cfg, device="cpu", seed=3).state_dict()
    words = wd.tokens()
    for beam in (2, 1):
        eng = Engine(cfg, wd, params, beam_size=beam, batch_bucket=2,
                     device="cpu")
        scores = eng.rank(" ".join(words[:3]),
                          [" ".join(words[i:i + 4]) for i in range(3)],
                          [(" ".join(words[5:7]), [" ".join(words[1:5])])])
        assert len(scores) == 3 and np.isfinite(scores).all()
        sugg = eng.suggest([" ".join(words[2:6]), " ".join(words[:2])])
        assert len(sugg) == beam
    assert lstm.lstm_fused.launches == 0
    assert beamgen.generator_topk_lse.launches == 0


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# the training entry point's modules: each must exist, and importing all of
# them must load neither JAX nor the JAX package
TRAINER_MODULES = (
    "cli.main", "config", "data.dataset", "data.loader", "data.pipeline",
    "data.synthetic", "decode.penalties", "eval.bleu", "eval.rank_metrics",
    "eval.rouge", "eval.text_metrics", "train.evaluate", "train.trainer",
    "utils.logging", "utils.meters",
    # the checkpoint codec and the data-preparation path
    "train.checkpoint", "train.flax_msgpack", "train.vocab_expand",
    "cli.prepare_data", "data.bm25", "data.fast", "data.fast_bm25",
    # the platform layer: the mesh, the dispatch table, profiling, and the
    # last ops modules
    "parallel.mesh", "ops.dispatch", "utils.profiling", "ops.attention",
    "ops.layers", "ops.rnn",
)


@pytest.mark.parametrize("module", TRAINER_MODULES)
def test_trainer_module_imports_no_jax(module):
    path = ROOT / "context_attentive_ir_tpu_torch" / (
        module.replace(".", "/") + ".py")
    assert path.is_file(), path
    assert path in _port_sources()
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"mods = {TRAINER_MODULES!r}\n"
        "for m in mods + ('serve', 'ops.kernels.lstm'):\n"
        "    importlib.import_module('context_attentive_ir_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'ml_dtypes', "
        "'context_attentive_ir_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from context_attentive_ir_tpu_torch.cli.main import main
    from context_attentive_ir_tpu_torch.config import RunConfig
    from context_attentive_ir_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, wd = _tiny()
    xp = torch.zeros(2, 3, 512)
    mask = torch.ones(2, 3, dtype=torch.bool)
    train = tmp_path / "t.jsonl"
    train.write_text("")
    for call in (lambda: Trainer(cfg, RunConfig(model_dir=str(tmp_path)),
                                 wd),
                 lambda: lstm.lstm_recurrence(xp, mask,
                                              torch.zeros(128, 512)),
                 lambda: main(["--train_file", str(train), "--model_dir",
                               str(tmp_path), "--vocab_size", "40"])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_decode_steps_return_the_alignment():
    """The coverage penalty reads the third value of a logits step: CARS
    and HRED-QS return their attention over the memory (as the JAX models
    do), rows summing to 1 over the valid positions."""
    from context_attentive_ir_tpu_torch.models import build_model

    tiny, _ = _tiny()
    dims = {f: getattr(tiny, f) for f in (
        "vocab_size", "emsize", "nhid", "nhid_ffnn", "max_query_len",
        "max_doc_len", "max_session_len", "num_candidates", "dropout",
        "dropout_emb", "dropout_rnn")}
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                        dtype=torch.bool)
    for model_type, rnn in (("cars", "lstm"), ("hredqs", "gru")):
        cfg = default_config(model_type).replace(rnn_type=rnn, **dims)
        model = build_model(cfg, device="cpu", seed=0)
        memory = torch.randn(3, 5, 2 * cfg.nhid)
        state = model.decoder.init_state(3)
        out = model.decode_step(state, torch.full((3,), 5), memory, mask)
        assert len(out) == 3
        logits, align = out[1], out[2]
        assert tuple(logits.shape) == (3, cfg.vocab_size)
        assert tuple(align.shape) == (3, 5)
        assert torch.allclose(align.sum(-1), torch.ones(3), atol=1e-5)
        assert float(align[~mask].abs().max()) == 0.0


# -- the package surface against the JAX package's ----------------------------
#
# name -> why the port does not export it (ROADMAP Queue 1's "deliberately
# not ported" list)
NOT_PORTED = {
    ".parallel": {"batch_sharding": "no reader in either package"},
}
# subpackages of the JAX package with no counterpart by name
NO_COUNTERPART = {".ops.pallas": "the TPU kernels; the port's are "
                                 ".ops.kernels"}
PORT_PACKAGE = "context_attentive_ir_tpu_torch"


def _subpackages(pkg):
    base = ROOT / pkg
    return sorted("" if d == base else
                  "." + ".".join(d.relative_to(base).parts)
                  for d in [base, *base.rglob("*")]
                  if (d / "__init__.py").is_file()
                  and "__pycache__" not in d.parts)


def _exports(module):
    """``__all__``, else the public classes and functions defined in the
    module itself (imports of other modules' names left out)."""
    import inspect

    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {name for name, v in vars(module).items()
            if not name.startswith("_")
            and (inspect.isclass(v) or inspect.isfunction(v))
            and getattr(v, "__module__", "") == module.__name__}


@pytest.mark.parametrize("sub", _subpackages(JAX_PACKAGE))
def test_subpackage_exports_match_jax(sub):
    import importlib

    if sub in NO_COUNTERPART:
        assert not (ROOT / PORT_PACKAGE / Path(*sub.strip(".").split("."))
                    / "__init__.py").is_file()
        return
    jax_mod = importlib.import_module(JAX_PACKAGE + sub)
    port_mod = importlib.import_module(PORT_PACKAGE + sub)
    skip = set(NOT_PORTED.get(sub, {}))
    missing = _exports(jax_mod) - set(dir(port_mod)) - skip
    assert not missing, f"{PORT_PACKAGE}{sub} lacks {sorted(missing)}"
    if hasattr(jax_mod, "__all__"):
        unlisted = (set(jax_mod.__all__) - skip
                    - set(getattr(port_mod, "__all__", ())))
        assert not unlisted, f"{PORT_PACKAGE}{sub}.__all__ lacks {unlisted}"


def test_not_ported_names_stay_out():
    import importlib

    for sub, names in NOT_PORTED.items():
        port_mod = importlib.import_module(PORT_PACKAGE + sub)
        for name in names:
            assert not hasattr(port_mod, name), (sub, name)


def test_engine_signature_takes_the_jax_order():
    """``Engine.__init__`` takes the JAX package's arguments in its order
    (a positional JAX-style call passes ``mesh`` as the mesh), with the
    port's own ``device`` last."""
    import inspect

    from context_attentive_ir_tpu.serve import Engine as JaxEngine

    jax_sig = inspect.signature(JaxEngine.__init__).parameters
    port_sig = inspect.signature(Engine.__init__).parameters
    assert list(port_sig) == list(jax_sig) + ["device"]
    for name in list(jax_sig)[1:]:
        assert port_sig[name].default == jax_sig[name].default, name


def test_aliases_are_the_same_objects():
    from context_attentive_ir_tpu_torch import data, decode, train
    from context_attentive_ir_tpu_torch.decode import penalties
    from context_attentive_ir_tpu_torch.models import recommenders

    assert decode.length_penalty is penalties.length_wu
    assert train.shapes_from_config is data.shapes_from_config
    assert set(recommenders.RECOMMENDER_CLASSES) == {"seq2seq", "hredqs",
                                                     "acg"}
    assert recommenders.RECOMMENDER_CLASSES["acg"] is recommenders.ACG
