"""The port's CLI (qadc_tpu_torch/cli/main.py) with `--device cpu`, beside the
JAX package's (qadc_tpu/cli/main.py) on the same files.

Data: tests/test_cli.py's draw (numpy seed 0; dim 32, 10 clusters; 2,000
learn, 5,000 base, 20 queries, exact top-10 ground truth). Training differs
between the packages (another PRNG), so recall is held to a floor, as
tests/test_cli.py holds it; index files, vecs files, quantizer files, the
CSV header and `info` are held to the JAX CLI's exactly.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from qadc_tpu.cli.main import main as jmain
from qadc_tpu.io import save_quantizer_file as jsave_quantizer_file
from qadc_tpu.io import save_vectors
from qadc_tpu.ops.knn import exact_knn
from qadc_tpu.quantizers.opq import train_opq as jtrain_opq
from qadc_tpu.quantizers.pq import train_pq as jtrain_pq
from qadc_tpu_torch.cli.main import main
from qadc_tpu_torch.io.checkpoint import load_index
from qadc_tpu_torch.io.vecs import load_vectors
from qadc_tpu_torch.ops.knn import assign_nearest

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
QADC_HEADER = "r,recall,ma,adc_type,keep,index_us,rotate_us,table_us,scan_us"
ADC_HEADER = "r,recall,ma,adc_type,index_us,rotate_us,table_us,scan_us"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    dim = 32
    centers = rng.normal(scale=3.0, size=(10, dim)).astype(np.float32)
    learn = (centers[rng.integers(0, 10, 2000)] + rng.normal(size=(2000, dim))).astype(np.float32)
    base = (centers[rng.integers(0, 10, 5000)] + rng.normal(size=(5000, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 10, 20)] + rng.normal(size=(20, dim))).astype(np.float32)
    _, gt = exact_knn(queries, base, 10)
    paths = {name: str(tmp / f"{name}.{ext}") for name, ext in
             (("learn", "fvecs"), ("base", "fvecs"), ("queries", "fvecs"), ("gt", "ivecs"))}
    for name, a in (("learn", learn), ("base", base), ("queries", queries),
                    ("gt", np.asarray(gt, np.int32))):
        save_vectors(paths[name], a)
    paths["tmp"] = tmp
    return paths


def _csv(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return lines[-2], lines[-1].split(",")


def test_flat_workflow(dataset, capsys):
    idx = str(dataset["tmp"] / "flat_idx")
    main(["create-flat", idx, "--train", dataset["learn"], "--sq", "16x4", *CPU])
    main(["add", idx, dataset["base"], "--chunk-size", "2048", *CPU])
    query = ["query", idx, dataset["queries"], dataset["gt"], "-r", "100", "-k", "5", "-b", "8"]
    main([*query, *CPU])
    header, fields = _csv(capsys)
    assert header == QADC_HEADER
    assert fields[0] == "100" and fields[2] == "1" and fields[3] == "qadc" and fields[4] == "0.05"
    assert float(fields[1]) > 0.85
    jmain(query)  # the JAX CLI on the port's index: the same header
    jheader, jfields = _csv(capsys)
    assert jheader == header and jfields[:5] == fields[:5]


def test_ivf_workflow(dataset, capsys):
    idx = str(dataset["tmp"] / "ivf_idx")
    main(["create-index", dataset["learn"], idx, "--parts", "16", "--sq", "16x4", "--opq", *CPU])
    main(["add", idx, dataset["base"], *CPU])
    main(["query", idx, dataset["queries"], dataset["gt"], "-r", "100", "-m", "8", "-k", "10",
          "-b", "8", *CPU])
    header, fields = _csv(capsys)
    assert header == QADC_HEADER and float(fields[1]) > 0.8
    query = ["query", idx, dataset["queries"], dataset["gt"], "-r", "100", "-m", "8",
             "--adc-type", "adc", "-b", "8"]
    main([*query, *CPU])
    header, fields = _csv(capsys)
    assert header == ADC_HEADER and float(fields[1]) > 0.8
    jmain(query)
    jheader, jfields = _csv(capsys)
    assert jheader == header and jfields[:4] == fields[:4]  # exact ADC: the same recall


def test_info_is_the_same_text_in_both_clis(dataset, capsys):
    ours, theirs = str(dataset["tmp"] / "info_port"), str(dataset["tmp"] / "info_jax")
    main(["create-index", dataset["learn"], ours, "--parts", "8", "--sq", "8x8", *CPU])
    main(["add", ours, dataset["base"], *CPU])
    jmain(["create-index", dataset["learn"], theirs, "--parts", "8", "--sq", "16x4", "--opq"])
    jmain(["add", theirs, dataset["base"]])
    capsys.readouterr()
    for idx in (ours, theirs):
        main(["info", idx, *CPU])
        port_text = capsys.readouterr().out
        jmain(["info", idx])
        assert capsys.readouterr().out == port_text
        assert "type: ivf" in port_text and "vectors: 5000" in port_text
    assert "sq=16x4" in port_text and "quantizer: opq" in port_text


def test_info_runs_as_a_module(dataset):
    idx = str(dataset["tmp"] / "module_idx")
    main(["create-flat", idx, "--train", dataset["learn"], "--sq", "8x4", *CPU])
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-m", "qadc_tpu_torch.cli.main", "info", idx, *CPU],
                         capture_output=True, text=True, env=env, timeout=120, check=True)
    assert out.stdout.splitlines() == [
        "type: flat", "vectors: 0", "quantizer: pq (dim=32, sq=8x4, code_size=4 bytes)"]


def test_split_is_byte_equal_to_the_jax_cli(dataset):
    for chunk_id in (0, 4):
        ours = str(dataset["tmp"] / f"chunk{chunk_id}.fvecs")
        theirs = str(dataset["tmp"] / f"jchunk{chunk_id}.fvecs")
        main(["split", str(chunk_id), "1100", dataset["base"], ours, *CPU])
        jmain(["split", str(chunk_id), "1100", dataset["base"], theirs])
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    assert load_vectors(ours).shape == (600, 32)


@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_convert_quantizer_is_byte_equal_to_the_jax_cli(dataset, kind):
    rng = np.random.default_rng(1)
    cb = rng.normal(size=(4, 16, 8)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(32, 32)))[0].astype(np.float32)
    pin = str(dataset["tmp"] / f"{kind}.pickle")
    with open(pin, "wb") as f:
        pickle.dump(cb if kind == "pq" else (cb, rot), f)
    ours = str(dataset["tmp"] / f"conv.{kind}.data")
    theirs = str(dataset["tmp"] / f"jconv.{kind}.data")
    main(["convert-quantizer", kind, pin, ours, *CPU])
    jmain(["convert-quantizer", kind, pin, theirs])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_create_index_takes_a_quantizer_the_jax_package_saved(dataset, capsys):
    """The reference's external-training workflow across the packages:
    create-index --residuals-out, a JAX-trained OPQ on the residuals, then
    create-index --quantizer (and set-quantizer) in the port's CLI."""
    idx = str(dataset["tmp"] / "ext_idx")
    res = str(dataset["tmp"] / "residuals.fvecs")
    main(["create-index", dataset["learn"], idx, "--parts", "8", "--sq", "4x4",
          "--residuals-out", res, *CPU])
    residuals = load_vectors(res)
    index = load_index(idx, device="cpu")
    learn = torch.from_numpy(load_vectors(dataset["learn"]))
    nearest = index.coarse_centroids[assign_nearest(learn, index.coarse_centroids).long()]
    np.testing.assert_array_equal(residuals, (learn - nearest).numpy())
    opq = jtrain_opq(jax.random.PRNGKey(9), residuals, 16, 4, opq_iters=3, kmeans_iters=8)
    qfile = str(dataset["tmp"] / "ext.opq.data")
    jsave_quantizer_file(qfile, opq)

    idx2 = str(dataset["tmp"] / "ext_idx2")
    main(["create-index", dataset["learn"], idx2, "--parts", "8", "--quantizer", qfile, *CPU])
    main(["set-quantizer", idx, qfile, *CPU])
    for path in (idx, idx2):
        got = load_index(path, device="cpu")
        assert got.n == 0 and (got.pq.sq_count, got.pq.sq_bits) == (16, 4)
        np.testing.assert_array_equal(got.pq.rotation.numpy(), np.asarray(opq.rotation))
    main(["add", idx, dataset["base"], *CPU])
    main(["query", idx, dataset["queries"], dataset["gt"], "-r", "100", "-m", "4", "-k", "10",
          "-b", "8", *CPU])
    assert float(_csv(capsys)[1][1]) > 0.8
    with pytest.raises(SystemExit, match="non-empty"):
        main(["set-quantizer", idx, qfile, *CPU])
    wrong = str(dataset["tmp"] / "wrong.pq.data")
    jsave_quantizer_file(wrong, jtrain_pq(jax.random.PRNGKey(1), learn.numpy()[:, :16], 4, 4,
                                          iters=2))
    with pytest.raises(SystemExit, match="dim"):
        main(["create-index", dataset["learn"], idx2, "--parts", "8", "--quantizer", wrong, *CPU])


def test_tune_prints_the_key(dataset, capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("QADC_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    idx, flat_idx = str(tmp_path / "ivf"), str(tmp_path / "flat")
    main(["create-index", dataset["learn"], idx, "--parts", "16", "--sq", "16x4", *CPU])
    main(["add", idx, dataset["base"], *CPU])
    main(["tune", idx, "--queries", dataset["queries"], "--batch", "8", "-r", "20", "--ma", "4",
          "--keep", "5", *CPU])
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("autotune ivf_qadc group_size=") for line in out) == 4
    assert out[-1].startswith("recorded ") and out[-1].endswith(
        "under cpu|ivf_qadc_grouped|m16x4|d32|pp1024|parts16|b8")
    main(["create-flat", flat_idx, "--train", dataset["learn"], *CPU])
    with pytest.raises(SystemExit, match="only IVF"):
        main(["tune", flat_idx, *CPU])
