"""PyTorch port, the multi-process (``dcn``, ``data``) mesh
(``emcid_torch.parallel.distributed`` and ``multi_slice_mesh``) on the
CPU: real processes in one ``gloo`` process group, started with
torchrun's environment, each running ``tests/torch_multiprocess_worker.py``.
Two layouts run at once: dcn 4 x data 1 (four processes) and dcn 2 x data
2 (two processes with two CPU entries each).

Tolerances: the mesh helpers exactly; the covariance sweep bit for bit
equal to a one-process mesh of as many shards, the same on every rank,
within 1e-5 relative of the JAX package's unsharded sweep on the same
tiny text encoder (carried across with ``models.convert``, as
``models.loader.from_jax`` does) and with the same count; the eval mean
exactly; Stage 1 of 3 concepts padded to 4 bit for bit equal to the
one-process mesh of as many shards (every output of the eps-pool run) and
within 1e-5 relative of the port unsharded (z, and the eps-pool run's z
and loss curve; its delta, a small difference of larger numbers, moves
by up to 3.5e-4 of its own largest entry on the one-process mesh too),
identical on every rank; generation's latents within 1e-5 relative and
uint8 images within one level; the K/V edit's prompt axis within 1e-6
relative of the one-process mesh of as many shards (its shards' terms
and gradients are summed in another order) and within 1e-4 of the port
unsharded (the one-process meshes of 2, 3 and 4 entries are 1.2e-5 to
2.2e-5 off it at these weights); ``run_emcid --tiny --platform cpu`` in two processes: only rank
0 writes, the edited fc2 weights identical on both ranks and within 1e-4
relative of one process's run, its images within one level.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import TINY_WORDS, one_torch_thread, rel_diff  # noqa: F401

WORKER = Path(__file__).parent / "torch_multiprocess_worker.py"
REPO = Path(__file__).parent.parent
LAYOUTS = {"4x1": (4, 1), "2x2": (2, 2)}  # tag: (processes, entries each)


def _free_ports(n: int) -> list:
    """``n`` distinct free ports (their sockets are held open together)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _jax_reference(shared: Path) -> dict:
    """The JAX package's tiny text encoder (seed 0): its unsharded
    covariance sweep, and its weights in the port's layout for the
    workers."""
    import jax

    from emcid_tpu.engine.layer_stats import layer_stats_text_encoder
    from emcid_tpu.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from emcid_tpu.models.loader import make_tiny_tokenizer

    from emcid_torch.models.convert import clip_text_to_torch
    from emcid_torch.models.loader import build_tiny_pipeline

    sys.path.insert(0, str(WORKER.parent))
    import torch_multiprocess_worker as w

    # the vocabulary of both packages' build_tiny_pipeline(words=TINY_WORDS)
    tok = make_tiny_tokenizer(
        TINY_WORDS + [f"w{i}" for i in range(32)]
        + ["photo", "of", "a", "an", "image", "painting", "by", "style",
           "artwork", "art", "cat", "dog", "realist", "artist", "vincent",
           "van", "gogh", "paint", "the", "in"], model_max_length=32)
    port_tok = build_tiny_pipeline(seed=0, words=TINY_WORDS,
                                   device="cpu").tokenizer
    enc = dict(padding="max_length", truncation=True, max_length=32)
    assert np.array_equal(np.asarray(tok(w.CAPTIONS, **enc)["input_ids"]),
                          np.asarray(port_tok(w.CAPTIONS, **enc)["input_ids"]))
    cfg = CLIPTextConfig(
        vocab_size=tok.vocab_size, hidden_size=32, intermediate_size=64,
        num_hidden_layers=4, num_attention_heads=4,
        max_position_embeddings=32, eos_token_id=tok.eos_token_id)
    text = CLIPTextEncoder(cfg)
    params = text.init_params(jax.random.PRNGKey(0), seq_len=32)
    stat = layer_stats_text_encoder(
        text, params, tok, w.LAYER, captions=w.CAPTIONS,
        force_recompute=True, batch_size=16, mesh=None)
    np.savez(shared / "text_params.npz", **clip_text_to_torch(
        jax.tree.map(np.asarray, params)))
    return dict(moment=np.asarray(stat.mom2.moment()),
                count=int(stat.mom2.count))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both layouts' workers, started together; the JAX reference; one
    process's ``run_emcid``.  Returns (JAX reference, {tag: [rank
    results]}, shared directory)."""
    shared = tmp_path_factory.mktemp("dcn")
    sys.path.insert(0, str(WORKER.parent))
    import torch_multiprocess_worker as w

    ref = _jax_reference(shared)
    w.write_cli_inputs(shared)
    procs = []
    for (tag, (n, entries)), port in zip(LAYOUTS.items(),
                                         _free_ports(len(LAYOUTS))):
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=f"{REPO}{os.pathsep}"
                       + os.environ.get("PYTHONPATH", ""))
            procs.append((tag, rank, subprocess.Popen(
                [sys.executable, str(WORKER), str(entries), str(shared)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=REPO)))
    # one process, no process group: the CLI's reference
    from emcid_torch.cli import run_emcid

    single, _ = run_emcid.main(w.cli_argv(shared, "single"))
    np.savez(shared / "cli_single.npz", **{
        k: v.numpy() for k, v in single.text_encoder.state_dict().items()
        if k.endswith("mlp.fc2.weight")})
    logs = []
    for tag, rank, p in procs:
        stdout, _ = p.communicate(timeout=300)
        logs.append((tag, rank, p.returncode, stdout))
    for tag, rank, code, stdout in logs:
        assert code == 0, f"{tag} rank {rank}:\n{stdout[-4000:]}"
    results = {tag: [json.loads((shared / f"out_{tag}_{r}.json").read_text())
                     for r in range(n)]
               for tag, (n, _) in LAYOUTS.items()}
    return ref, results, shared, logs


@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_layout(runs, tag):
    """default_mesh under the group, the (dcn, data) mesh's shape and
    first shard, shard_batch/gather in global order, the eval mean."""
    _, results, _, logs = runs
    n, entries = LAYOUTS[tag]
    for r in results[tag]:
        assert r["world"] == n and r["backend"] == "gloo"
        assert r["default_axes"] == ["dcn", "data"]
        assert r["default_shape"] == [n, 1]
        assert r["mesh_axes"] == ["dcn", "data"]
        assert r["mesh_shape"] == [n, entries]
        assert r["first"] == r["rank"] * entries
        assert r["own_shards_ok"] and r["round_trip_ok"]
        assert r["eval_mean"] == float(np.arange(16).mean())
    printed = [s for t, _, _, s in logs if t == tag]
    assert all("backend gloo (ranks on the CPU)" in s for s in printed)


@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_covariance(runs, tag):
    """Bit for bit the one-process mesh of as many shards, on every rank;
    the cache written by rank 0 only and hit by every rank; within 1e-5
    of the JAX package's unsharded sweep, with its count."""
    ref, results, shared, _ = runs
    moments = [np.load(shared / f"cov_{tag}_{r['rank']}.npy")
               for r in results[tag]]
    for r, m in zip(results[tag], moments):
        assert r["cov_bitwise_twin"] and r["cov_cache_hit_equal"]
        assert r["cov_count"] == r["cov_twin_count"] == r["cov_cache_count"]
        assert r["cov_count"] == ref["count"]
        assert r["cov_saves"] == (1 if r["rank"] == 0 else 0)
        assert np.array_equal(m, moments[0])
    assert rel_diff(ref["moment"], moments[0]) <= 1e-5


@pytest.mark.parametrize("check", ["stage1", "generation", "kv_edit"])
def test_sharded_equals_unsharded(runs, check):
    """dcn 4 x data 1: each rank against the port unsharded; Stage 1's z
    and loss curve the same on every rank."""
    _, results, shared, _ = runs
    rows = results["4x1"]
    if check == "stage1":
        zs = [np.load(shared / f"z_{r['rank']}.npy") for r in rows]
        losses = [np.load(shared / f"losses_{r['rank']}.npy") for r in rows]
        assert zs[0].shape == (3, 1, 32)
        for r, z, loss in zip(rows, zs, losses):
            assert r["stage1_twin_bitwise"] and r["pool_twin_bitwise"]
            assert r["stage1_z_rel"] <= 1e-5 and r["pool_z_rel"] <= 1e-5
            assert r["pool_loss_rel"] <= 1e-5
            assert np.array_equal(z, zs[0])
            assert np.array_equal(loss, losses[0])
    elif check == "generation":
        for r in rows:
            assert r["latents_rel"] <= 1e-5
            assert r["images_shape"] == [6, 16, 16, 3]
            assert r["images_max_level"] <= 1
    else:
        assert all(r["kv_twin_rel"] <= 1e-6 for r in rows)
        assert all(r["kv_rel"] <= 1e-4 for r in rows)


def test_cli_two_processes(runs):
    """``run_emcid`` under a two-process group: only rank 0 wrote (its
    images, covariance and z caches), the edit equals one process's."""
    from PIL import Image

    _, results, shared, _ = runs
    rows = results["2x2"]
    assert rows[0]["cli_writes"] > 0 and rows[1]["cli_writes"] == 0
    edits = [dict(np.load(shared / f"cli_{r['rank']}.npz")) for r in rows]
    single = dict(np.load(shared / "cli_single.npz"))
    assert set(edits[0]) == set(single) and len(single) == 4
    for k in single:
        assert np.array_equal(edits[0][k], edits[1][k])
        assert rel_diff(single[k], edits[0][k]) <= 1e-4, k
    for phase in ("pre_edit", "post_edit"):
        names = sorted(p.name for p in (shared / "out_single"
                                        / phase).iterdir())
        assert names == sorted(p.name for p in (shared / "out_sharded"
                                                / phase).iterdir())
        assert len(names) == 4
        for name in names:
            a, b = (np.asarray(Image.open(shared / f"out_{t}" / phase / name),
                               int) for t in ("single", "sharded"))
            assert np.abs(a - b).max() <= 1, (phase, name)
