"""parallel_examples/gpubatch (prepare / one job a tile / stitch over an
object store) driven with --device cpu: the counterpart of
test_batch_pipeline.py, plus parity. The local backend end to end in a
fresh interpreter that can import neither JAX nor the JAX package; its
output against the JAX package's 3-phase API with the JAX-fitted centres
shared through prepare.pkl, and against the port's own serial run
(integer outputs bit for bit, float RAT columns to 1e-6 relative); the
slurm emitter; the object store's directory round trip; a failing tile
job; a prepare.pkl written for one device run under another."""

import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pyshepseg_tpu import tiling as jax_tiling
from pyshepseg_tpu import tilingstats as jax_tilingstats
from pyshepseg_tpu_torch import io as rio
from pyshepseg_tpu_torch import tiling
from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans, kmeansFromReference
from torch_parity import read_output

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "parallel_examples", "gpubatch")
GRID = dict(tileSize=64, overlapSize=32)
GRID_ARGS = ["--tilesize", "64", "--overlapsize", "32", "--nclusters", "12"]
STATS_BANDS = (1, 2)
# float RAT columns (means, standard deviations) against the JAX run
RTOL = 1e-6


def script(name):
    return os.path.join(EXAMPLES, name)


def run(cmd, env, timeout=600):
    return subprocess.run([sys.executable] + cmd, capture_output=True,
                          text=True, env=env, timeout=timeout)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The environment of every batch subprocess: PYSHEPSEG_TPU_PLATFORM
    is set (with it, loading the JAX package imports jax) and PYTHONPATH
    starts with a ``jax`` and a ``pyshepseg_tpu`` that raise when imported,
    so a phase that imports either fails, and with it the test."""
    poison = tmp_path_factory.mktemp("poison")
    for name in ("jax", "pyshepseg_tpu"):
        (poison / name).mkdir()
        (poison / name / "__init__.py").write_text(
            "raise ImportError('a gpubatch phase imported %s')\n" % name)
    return dict(os.environ, PYSHEPSEG_TPU_PLATFORM="cpu",
                OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [str(poison), REPO, os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The 96 x 96 3-band scene of test_batch_pipeline.py."""
    rng = np.random.default_rng(42)
    h = w = 96
    ncells = 12
    centres = rng.uniform(0, [h, w], size=(ncells, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = ((yy[..., None] - centres[:, 0]) ** 2 +
         (xx[..., None] - centres[:, 1]) ** 2)
    cells = d.argmin(axis=-1)
    palette = rng.integers(200, 9000, size=(ncells, 3)).astype(np.uint16)
    path = str(tmp_path_factory.mktemp("scene") / "scene.npseg")
    ds = rio.create(path, w, h, 3, np.uint16)
    ds.SetGeoTransform((0, 1, 0, 0, 0, -1))
    for b in range(3):
        band = ds.GetRasterBand(b + 1)
        band.SetNoDataValue(0)
        band.WriteArray(palette[cells, b])
    ds.FlushCache()
    return path


def rat_columns(path):
    """{column name: values} of a segment raster's attribute table."""
    rat = rio.open(path).GetRasterBand(1).GetDefaultRAT()
    return {rat.GetNameOfCol(i): np.asarray(rat.ReadAsArray(i))
            for i in range(rat.GetColumnCount())}


def tile_lines(stdout):
    """The TILEJOB records the tile jobs printed, by tile index."""
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines()
            if ln.startswith("TILEJOB ")]
    return {rec["index"]: rec for rec in recs}


# ---- the local backend end to end, no JAX in any phase


@pytest.fixture(scope="module")
def local_run(scene, env, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("local")
    store = str(tmp / "store")
    res = run([script("submit_pyshepseg_job.py"), "--backend", "local",
               "--infile", scene, "--store", "file://" + store,
               "--statsbands", "1", "--workers", "2", "--device", "cpu",
               "--fixedkmeansinit"] + GRID_ARGS, env)
    return dict(res=res, store=store, tmp=tmp)


def test_local_batch_pipeline(local_run):
    res = local_run["res"]
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NUMTILES=4" in res.stdout
    assert "pipeline complete" in res.stdout
    seg, hist = read_output(os.path.join(local_run["store"],
                                         "segmentation.npseg"))
    assert seg.shape == (96, 96)
    # every pixel labelled with ids 1..max, a RAT row for every id
    np.testing.assert_array_equal(np.unique(seg),
                                  np.arange(1, seg.max() + 1))
    np.testing.assert_array_equal(hist[1:], np.bincount(seg.ravel())[1:])
    cols = rat_columns(os.path.join(local_run["store"],
                                    "segmentation.npseg"))
    assert {"Histogram", "Band_1_mean", "Band_1_stddev"} <= set(cols)
    # tiles and state cleaned from the store after the stitch
    assert os.listdir(local_run["store"]) == ["segmentation.npseg"]


def test_tile_jobs_report_themselves(local_run):
    """One TILEJOB line a tile: its stages' seconds, no kernel launch on
    the CPU, the device it was given."""
    recs = tile_lines(local_run["res"].stdout)
    assert sorted(recs) == [0, 1, 2, 3]
    for rec in recs.values():
        assert rec["device"] == "cpu"
        assert rec["launches"] == {"local_ccl": 0, "lut_gather": 0}
        secs = rec["seconds"]
        assert set(secs) == {"import", "torch", "cudainit", "kernels",
                             "build", "download", "doOne", "reading",
                             "upload", "total"}
        assert 0 < secs["torch"] < secs["import"]
        assert secs["cudainit"] == secs["kernels"] == secs["build"] == 0
        assert 0 < secs["reading"] < secs["doOne"] < secs["total"]
        assert secs["import"] + secs["doOne"] <= secs["total"]


def test_local_run_equals_serial_run(local_run, scene):
    """The batch run fits its own k-means (fixed init, as
    doTiledShepherdSegmentation does with the same arguments): same output
    bit for bit."""
    out = str(local_run["tmp"] / "serial.npseg")
    tiling.doTiledShepherdSegmentation(
        scene, out, numClusters=12, fixedKMeansInit=True, device="cpu",
        **GRID)
    seg, hist = read_output(os.path.join(local_run["store"],
                                         "segmentation.npseg"))
    seg0, hist0 = read_output(out)
    np.testing.assert_array_equal(seg, seg0)
    np.testing.assert_array_equal(hist, hist0)


# ---- parity with the JAX package under shared centres; the state
# ---- of one device under another device argument


@pytest.fixture(scope="module")
def prepared(scene, env, tmp_path_factory):
    """One do_prepare.py job: its store directory and its output."""
    store = str(tmp_path_factory.mktemp("prepared") / "store")
    res = run([script("do_prepare.py"), "--infile", scene, "--store",
               "file://" + store, "--device", "cpu", "--fixedkmeansinit"]
              + GRID_ARGS, env)
    assert res.returncode == 0, res.stdout + res.stderr
    return store


def load_state(store):
    with open(os.path.join(store, "prepare.pkl"), "rb") as f:
        return pickle.load(f)


def store_with_kmeans(prepared, store, kmeansObj):
    """A new store whose prepare.pkl is the prepared one with another
    k-means object."""
    state = load_state(prepared)
    state["kmeansObj"] = kmeansObj
    os.makedirs(store)
    with open(os.path.join(store, "prepare.pkl"), "wb") as f:
        pickle.dump(state, f)
    return state


def run_tiles_and_stitch(store, env, ntiles):
    """Every tile job at once, then the stitch, as separate processes."""
    procs = [subprocess.Popen(
        [sys.executable, script("do_tile.py"), "--store", "file://" + store,
         "--index", str(i), "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for i in range(ntiles)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stdout + stderr
    res = run([script("do_stitch.py"), "--store", "file://" + store,
               "--statsbands", ",".join(map(str, STATS_BANDS)),
               "--device", "cpu"], env)
    assert res.returncode == 0, res.stdout + res.stderr


def stats_cols(band):
    return [("Band_{}_mean".format(band), "mean"),
            ("Band_{}_stddev".format(band), "stddev")]


@pytest.fixture(scope="module")
def parity(scene, prepared, env, tmp_path_factory):
    """The same scene and the same (JAX-fitted) centres through the JAX
    package's 3-phase API in process, through gpubatch's tile and stitch
    jobs, and through the port's doTiledShepherdSegmentation."""
    tmp = tmp_path_factory.mktemp("parity")
    # the JAX side: what parallel_examples/tpubatch's phases call
    (inDs, bands, jaxKm, _, nullVal, tileInfo) = (
        jax_tiling.doTiledShepherdSegmentation_prepare(
            scene, numClusters=12, fixedKMeansInit=True, **GRID))
    tileFiles = {}
    for (col, row) in tileInfo.tiles:
        tileFiles[(col, row)] = str(tmp / "jax_{}_{}.npseg".format(col, row))
        jax_tiling.doTiledShepherdSegmentation_doOne(
            scene, tileFiles[(col, row)], tileInfo, col, row, bands,
            nullVal, jaxKm)
    jaxOut = str(tmp / "jax.npseg")
    (_, _, outDs) = jax_tiling.doTiledShepherdSegmentation_finalize(
        scene, jaxOut, tileFiles, tileInfo, GRID["overlapSize"], str(tmp),
        outputDriver=None)
    outDs.FlushCache()
    del outDs
    for band in STATS_BANDS:
        jax_tilingstats.calcPerSegmentStatsTiled(scene, band, jaxOut,
                                                 stats_cols(band))

    # gpubatch: the prepared state with the JAX centres
    store = str(tmp / "store")
    km = kmeansFromReference(jaxKm, device="cpu")
    state = store_with_kmeans(prepared, store, km)
    assert state["colRowList"] == sorted(tileInfo.tiles,
                                         key=lambda x: (x[1], x[0]))
    run_tiles_and_stitch(store, env, len(state["colRowList"]))

    # the port's serial run with the same centres
    serialOut = str(tmp / "serial.npseg")
    tiling.doTiledShepherdSegmentation(scene, serialOut, kmeansObj=km,
                                       device="cpu", **GRID)
    return dict(batch=os.path.join(store, "segmentation.npseg"),
                jax=jaxOut, serial=serialOut, store=store)


def test_prepare_state(prepared, scene):
    """prepare.pkl holds what the tile jobs and the stitch read; its
    k-means object is numpy state and remembers its device as a string."""
    state = load_state(prepared)
    assert set(state) == {"tileInfo", "colRowList", "bandNumbers",
                          "imgNullVal", "kmeansObj", "overlapSize",
                          "infile"}
    assert state["infile"] == scene
    assert state["bandNumbers"] == [1, 2, 3]
    assert state["overlapSize"] == 32
    assert len(state["colRowList"]) == 4
    km = state["kmeansObj"]
    assert isinstance(km, TorchKMeans) and km.device == "cpu"
    assert isinstance(km.cluster_centers_, np.ndarray)
    assert km.cluster_centers_.shape == (12, 3)


def test_batch_segments_equal_jax(parity):
    seg, hist = read_output(parity["batch"])
    segJax, histJax = read_output(parity["jax"])
    assert seg.dtype == segJax.dtype == np.uint32
    np.testing.assert_array_equal(seg, segJax)
    np.testing.assert_array_equal(hist, histJax)
    assert seg.max() >= 1


@pytest.mark.parametrize("column", ["Histogram"] + [
    name for band in STATS_BANDS for (name, _) in stats_cols(band)])
def test_batch_rat_column_equals_jax(parity, column):
    got = rat_columns(parity["batch"])
    want = rat_columns(parity["jax"])
    assert set(got) == set(want)
    assert got[column].shape == want[column].shape
    if column == "Histogram":
        np.testing.assert_array_equal(got[column], want[column])
    else:
        np.testing.assert_allclose(got[column], want[column], rtol=RTOL,
                                   atol=0)


def test_batch_equals_port_serial(parity):
    seg, hist = read_output(parity["batch"])
    seg0, hist0 = read_output(parity["serial"])
    np.testing.assert_array_equal(seg, seg0)
    np.testing.assert_array_equal(hist, hist0)


def test_stitch_cleans_the_store(parity):
    assert os.listdir(parity["store"]) == ["segmentation.npseg"]


def test_state_of_one_device_runs_under_another(prepared, env, tmp_path):
    """The k-means object's own ``device`` does not decide where a tile
    runs: a prepare.pkl whose object names a CUDA device (as a GPU node
    writes it) runs a tile job under --device cpu here, with the result
    of the object that names the CPU; and the fit's device survives the
    pickle as a plain string."""
    state = load_state(prepared)
    km = state["kmeansObj"]
    onCard = TorchKMeans.from_arrays(km.cluster_centers_, device="cuda:3")
    assert pickle.loads(pickle.dumps(onCard)).device == "cuda:3"
    store = str(tmp_path / "store")
    store_with_kmeans(prepared, store, onCard)
    env = dict(env, SLURM_ARRAY_TASK_ID="1")     # no --index: the env's
    res = run([script("do_tile.py"), "--store", "file://" + store,
               "--device", "cpu"], env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert tile_lines(res.stdout)[1]["device"] == "cpu"
    col, row = state["colRowList"][1]
    name = "tile_{}_{}.npseg".format(col, row)
    want = str(tmp_path / "want.npseg")
    tiling.doTiledShepherdSegmentation_doOne(
        state["infile"], want, state["tileInfo"], col, row,
        state["bandNumbers"], state["imgNullVal"], km, device="cpu")
    np.testing.assert_array_equal(
        rio.open(os.path.join(store, name)).GetRasterBand(1).ReadAsArray(),
        rio.open(want).GetRasterBand(1).ReadAsArray())


# ---- failures


def test_failed_tile_job_fails_the_submission(scene, env, tmp_path):
    """Every tile job dies on a threshold that is no number: the submit
    script exits non-zero, names the job, and never stitches."""
    store = str(tmp_path / "store")
    res = run([script("submit_pyshepseg_job.py"), "--backend", "local",
               "--infile", scene, "--store", "file://" + store,
               "--workers", "4", "--device", "cpu", "--fixedkmeansinit",
               "--maxspectraldiff", "notanumber"] + GRID_ARGS, env)
    assert res.returncode != 0
    assert "do_tile.py" in res.stderr and "job failed" in res.stderr
    assert "do_stitch.py" not in res.stdout
    assert os.listdir(store) == ["prepare.pkl"]


def test_stitch_fails_on_a_missing_tile(prepared, env, tmp_path):
    """A hole is an error: the stitch job with no tile in the store exits
    non-zero and uploads nothing."""
    store = str(tmp_path / "store")
    shutil.copytree(prepared, store)
    res = run([script("do_stitch.py"), "--store", "file://" + store,
               "--device", "cpu"], env)
    assert res.returncode != 0
    assert os.listdir(store) == ["prepare.pkl"]


@pytest.mark.parametrize("phase", ["do_prepare.py", "do_tile.py",
                                   "do_stitch.py"])
def test_phase_raises_without_a_card(phase, scene, prepared, env, tmp_path):
    """The default device is cuda, and no phase carries on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    store = str(tmp_path / "store")
    shutil.copytree(prepared, store)
    args = {"do_prepare.py": ["--infile", scene] + GRID_ARGS,
            "do_tile.py": ["--index", "0"], "do_stitch.py": []}[phase]
    res = run([script(phase), "--store", "file://" + store] + args, env)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert os.listdir(store) == ["prepare.pkl"]


# ---- the emitters


def test_slurm_emit(scene, tmp_path):
    emit = str(tmp_path / "jobs")
    res = run([script("submit_pyshepseg_job.py"), "--backend", "slurm",
               "--infile", scene, "--store", "file:///x", "--emit-dir",
               emit, "--fixedkmeansinit"], None, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert sorted(os.listdir(emit)) == [
        "psseg_prepare.sbatch", "psseg_stitch.sbatch", "psseg_tiles.sbatch",
        "submit_all.sh"]
    # array size and job-id dependencies are wired at submission time by
    # the orchestrator (sbatch CLI options override in-file directives)
    orch = open(os.path.join(emit, "submit_all.sh")).read()
    assert "--array=0-$((numtiles - 1))" in orch
    assert "--dependency=afterok:${tiles_id}" in orch
    assert "--parsable --wait" in orch
    assert subprocess.run(["bash", "-n", os.path.join(emit, "submit_all.sh")],
                          capture_output=True).returncode == 0
    # one GPU a job, the port's scripts, the device passed to each phase
    for name in ("psseg_prepare", "psseg_tiles", "psseg_stitch"):
        body = open(os.path.join(emit, name + ".sbatch")).read()
        assert "#SBATCH --gres=gpu:1" in body
        assert os.path.join("gpubatch", "do_") in body
        assert "--device cuda" in body
    assert "--fixedkmeansinit" in open(
        os.path.join(emit, "psseg_prepare.sbatch")).read()


def test_gcpbatch_emit(scene, tmp_path):
    emit = str(tmp_path / "jobs")
    res = run([script("submit_pyshepseg_job.py"), "--backend", "gcpbatch",
               "--infile", scene, "--store", "gs://bucket/run", "--emit-dir",
               emit, "--container-image", "registry/worker:latest"], None,
              timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    spec = json.load(open(os.path.join(emit, "psseg_tiles.json")))
    assert spec["taskGroups"][0]["taskCount"] == "NUMTILES"
    inst = spec["allocationPolicy"]["instances"][0]
    assert inst["installGpuDrivers"] is True
    assert inst["policy"]["accelerators"] == [
        {"type": "nvidia-h100-80gb", "count": 1}]
    container = spec["taskGroups"][0]["taskSpec"]["runnables"][0]["container"]
    assert container["imageUri"] == "registry/worker:latest"
    assert container["commands"][0] == "do_tile.py"
    assert container["commands"][1:5] == ["--store", "gs://bucket/run",
                                          "--device", "cuda"]


# ---- the object store


def test_objectstore_cloud_backend_handles_directories(tmp_path):
    # .npseg artifacts are DIRECTORIES; the cloud backends must store
    # one object per contained file and reassemble on download. Exercise
    # the walk/list/reassemble logic through a stubbed per-object layer.
    # Loaded by path under a name of its own: tpubatch has an objstore too.
    spec = importlib.util.spec_from_file_location("gpubatch_objstore",
                                                  script("objstore.py"))
    objstore = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(objstore)

    class FakeCloudStore(objstore.ObjectStore):
        def __init__(self):
            self.kind = "s3"
            self.prefix = "pfx"
            self.objects = {}

        def _uploadFile(self, localPath, key):
            with open(localPath, "rb") as f:
                self.objects[self._key(key)] = f.read()

        def _downloadFile(self, key, localPath):
            with open(localPath, "wb") as f:
                f.write(self.objects[self._key(key)])

        def _deleteObject(self, key):
            self.objects.pop(self._key(key), None)

        def _listSubKeys(self, key):
            pfx = self._key(key) + "/"
            return [k[len(pfx):] for k in self.objects if k.startswith(pfx)]

    store = FakeCloudStore()
    src = tmp_path / "tile.npseg"
    (src / "sub").mkdir(parents=True)
    (src / "meta.json").write_text("{}")
    (src / "band_1.npy").write_bytes(b"\x01\x02")
    (src / "sub" / "col_0.npy").write_bytes(b"\x03")

    store.upload(str(src), "tiles/tile_0_0.npseg")
    assert set(store.objects) == {
        "pfx/tiles/tile_0_0.npseg/meta.json",
        "pfx/tiles/tile_0_0.npseg/band_1.npy",
        "pfx/tiles/tile_0_0.npseg/sub/col_0.npy"}

    dst = tmp_path / "back.npseg"
    store.download("tiles/tile_0_0.npseg", str(dst))
    assert (dst / "meta.json").read_text() == "{}"
    assert (dst / "band_1.npy").read_bytes() == b"\x01\x02"
    assert (dst / "sub" / "col_0.npy").read_bytes() == b"\x03"

    # plain single files still round-trip
    one = tmp_path / "prepare.pkl"
    one.write_bytes(b"pickle")
    store.upload(str(one), "prepare.pkl")
    got = tmp_path / "prepare_back.pkl"
    store.download("prepare.pkl", str(got))
    assert got.read_bytes() == b"pickle"

    store.delete("tiles/tile_0_0.npseg")
    store.delete("prepare.pkl")
    assert store.objects == {}

    # the file backend: a directory round trip through a real store
    fileStore = objstore.ObjectStore("file://" + str(tmp_path / "fs"))
    fileStore.upload(str(src), "tile.npseg")
    back = fileStore.download("tile.npseg", str(tmp_path / "fsback.npseg"))
    assert (tmp_path / "fsback.npseg" / "sub" / "col_0.npy").read_bytes() \
        == b"\x03" and back == str(tmp_path / "fsback.npseg")
    fileStore.delete("tile.npseg")
    assert os.listdir(str(tmp_path / "fs")) == []
    with pytest.raises(ValueError):
        objstore.ObjectStore("ftp://nowhere")
