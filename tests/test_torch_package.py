"""The port's package rules: it imports neither JAX (nor flax, optax,
msgpack or ml_dtypes: the machine with the card has neither of the last
two) nor any module of ``persia_tpu``; importing it loads none of them; and
its entry points raise without a card unless the caller asks for the
CPU."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "persia_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes", "persia_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


NATIVE_MODULES = ("data_loader.py", "embedding/_native_build.py", "embedding/native_store.py",
                  "embedding/native_worker.py", "jobstate.py", "checkpoint.py", "serialization.py")
# the DIN / Avazu slice: its models, its two ops and the synthetic data
SLICE_MODULES = ("models/din.py", "models/deepfm.py", "models/dcn.py", "models/layers.py", "ops/raw_gather.py",
                 "ops/attention_pool.py", "testing/__init__.py", "testing/datasets.py", "testing/envelopes.py")
# the cache tier: its package and its two ops
CACHE_MODULES = tuple(f"embedding/hbm_cache/{m}.py" for m in ("__init__", "common", "directory", "groups", "step",
                                                               "tier", "ctx")) + ("ops/cache_aux.py",
                                                                                  "ops/cached_gather.py")


def test_port_sources_import_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    assert all(PORT / m in files for m in NATIVE_MODULES + SLICE_MODULES + CACHE_MODULES)
    bad = [
        f"{f.relative_to(ROOT)}:{line} imports {root}"
        for f in files
        for root, line in _imported_roots(f)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, json, sys\n"
        "roots = ('jax', 'flax', 'optax', 'msgpack', 'ml_dtypes', 'persia_tpu')\n"
        "before = {m for m in sys.modules if m.split('.')[0] in roots}\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "after = {m for m in sys.modules if m.split('.')[0] in roots}\n"
        "print(json.dumps(sorted(after - before)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.device import resolve_device
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.serving.engine import InferenceEngine

    cfg = EmbeddingConfig(slots_config={"a": SlotConfig(dim=16)})
    worker = EmbeddingWorker(cfg, [EmbeddingStore()])
    model = DLRM(13, 1, device="cpu")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        InferCtx(model, worker, cfg)
    ctx = InferCtx(model, worker, cfg, device="cpu")
    with pytest.raises(RuntimeError):
        InferenceEngine(ctx)
    assert InferenceEngine(ctx, device="cpu").device == torch.device("cpu")


def test_train_ctx_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM

    cfg = EmbeddingConfig(slots_config={"a": SlotConfig(dim=16)})
    worker = EmbeddingWorker(cfg, [EmbeddingStore()])
    model = DLRM(13, 1, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(RuntimeError):
        TrainCtx(model, opt, Adagrad(), worker, cfg)
    with pytest.raises(ValueError):
        TrainCtx(model, opt, Adagrad(), worker, cfg, device="cpu", wire_dtype="float16")
    assert TrainCtx(model, opt, Adagrad(), worker, cfg, device="cpu").device == torch.device("cpu")


def test_din_train_ctx_and_models_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DCNv2, DeepFM, DIN

    for build in (lambda d: DIN(1, 2, 2, device=d), lambda d: DeepFM(2, 21, device=d),
                  lambda d: DCNv2(2, 21, device=d)):
        with pytest.raises(RuntimeError):
            build(None)
    cfg = EmbeddingConfig(slots_config={
        "item": SlotConfig(dim=16),
        "hist_item": SlotConfig(dim=16, embedding_summation=False, sample_fixed_size=50),
    }, feature_groups={"items": ["item", "hist_item"]})
    worker = EmbeddingWorker(cfg, [EmbeddingStore()])
    model = DIN(1, 1, 1, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(RuntimeError):
        TrainCtx(model, opt, Adagrad(), worker, cfg)
    assert TrainCtx(model, opt, Adagrad(), worker, cfg, device="cpu").device == torch.device("cpu")


def test_native_cores_are_the_ports_own_copies():
    """The host cores build from ``persia_tpu_torch/native`` (not the
    reference's ``native/``) into a directory git ignores."""
    from persia_tpu_torch.embedding import _native_build

    from persia_tpu_torch.embedding.hbm_cache import directory

    assert _native_build.NATIVE_SRC == PORT / "native"
    assert {p.name for p in _native_build.NATIVE_SRC.glob("*.cpp")} == {"cache.cpp", "ps.cpp", "worker.cpp"}
    # the cache directory: the port's trimmed copy, with the stream's
    # pending map and fused feeder and the sharded directory, without the
    # access sketch
    src = (PORT / "native" / "cache.cpp").read_text()
    for present in ("void* cache_create(", "cache_admit_positions(", "cache_init_rows(", "void* pending_map_create(",
                    "int64_t cache_feed_batch(", "int64_t cache_feed_batch_sharded(", "void* cache_create_sharded("):
        assert present in src, present
    for absent in ("AccessSketch", "sketch_observe"):
        assert absent not in src, absent
    assert src != (ROOT / "native" / "cache.cpp").read_text()
    so = directory.build_native()
    assert so.parent == _native_build.BUILD_DIR and so.name == "libpersia_torch_cache.so"
    rel = _native_build.BUILD_DIR.relative_to(ROOT).as_posix()
    assert rel + "/" in (ROOT / ".gitignore").read_text().split()


def test_fused_tier_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec, init_fused_state

    specs = {"a": FusedSlotSpec(vocab=8, dim=16)}
    model = DLRM(13, 1, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(RuntimeError):
        FusedTrainCtx(model, opt, Adagrad(), specs)
    with pytest.raises(RuntimeError):
        init_fused_state(model, opt, torch.Generator(), specs, Adagrad().config)
    assert FusedTrainCtx(model, opt, Adagrad(), specs, device="cpu").device == torch.device("cpu")


def test_cache_tier_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM

    cfg = EmbeddingConfig(slots_config={"a": SlotConfig(dim=16)})
    worker = EmbeddingWorker(cfg, [EmbeddingStore()])
    model = DLRM(13, 1, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(RuntimeError):
        CachedTrainCtx(model, opt, Adagrad(), worker, cfg, cache_rows=64)
    ctx = CachedTrainCtx(model, opt, Adagrad(), worker, cfg, cache_rows=64, device="cpu")
    assert ctx.device == torch.device("cpu") and ctx.init_state().tables["cache_d16"].shape == (65, 16)
