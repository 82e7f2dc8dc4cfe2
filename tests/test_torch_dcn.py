"""The port's multi-host (DCN) backend (parallel/dcn, cmdline/dcnworkercmd)
run as N local CPU processes: each runs the real code path (TCPStore
barriers, KV broadcast of the k-means model and tile grid, status, error
and timing records, round-robin tile shards, tile hand-off through the
work directory, stitch on process 0). Output must equal the port's serial
run (which test_torch_tiling.py holds against the JAX package) bit for
bit. Every worker runs with PYSHEPSEG_TPU_PLATFORM set and a ``jax``
package first on its path that raises when imported, and asserts that
neither JAX nor the JAX package was loaded. Every wait on a subprocess has
its own timeout, and what is left is killed."""

import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from pyshepseg_tpu_torch import tiling
from pyshepseg_tpu_torch.parallel import dcn
from test_tiling import make_voronoi_raster
from test_torch_tiling import RUN, torch_kmeans
from torch_parity import read_output

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 300


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


DRIVER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans
    from pyshepseg_tpu_torch.parallel import dcn
    # sabotage
    (coord, pid, nproc, inpath, outpath, localdev, tpd) = sys.argv[1:8]
    centres = (100 + 40 * np.arange(20)[:, None] +
               np.zeros((1, 3))).astype(np.float32)
    res = dcn.doTiledShepherdSegmentationDistributed(
        inpath, outpath, os.path.dirname(outpath),
        tileSize=64, overlapSize=16, minSegmentSize=10, numClusters=20,
        kmeansObj=TorchKMeans.from_arrays(centres, device="cpu"),
        fourConnected=True, maxSpectralDiff=30.0, coordinatorAddress=coord,
        numProcesses=int(nproc), processId=int(pid), barrierTimeout=120,
        tilesPerDevice=int(tpd), device="cpu",
        localDevices=["cpu"] * int(localdev))
    assert "jax" not in sys.modules, "jax imported"
    assert "pyshepseg_tpu" not in sys.modules, "pyshepseg_tpu imported"
    if int(pid) == 0:
        assert res is not None and res.maxSegId > 0
        summary = res.timings.makeSummaryDict()
        assert "segmentation" in summary and "stitchtiles" in summary
        print("MAXSEGID", res.maxSegId)
    else:
        assert res is None
""")


@pytest.fixture
def worker_env(tmp_path):
    """The workers' environment: the repo on the path behind a ``jax``
    that raises, the platform variable set (with it, loading the JAX
    package imports jax), one thread each."""
    poison = tmp_path / "poison" / "jax"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('a DCN worker imported jax')\n")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(poison.parent), REPO]), OMP_NUM_THREADS="1",
        PYSHEPSEG_TPU_PLATFORM="cpu")


@pytest.fixture
def scene(tmp_path):
    """The test raster and the port's serial run of it."""
    inpath = str(tmp_path / "in.npseg")
    make_voronoi_raster(inpath, np.random.default_rng(42))
    out = str(tmp_path / "serial.npseg")
    res = tiling.doTiledShepherdSegmentation(
        inpath, out, kmeansObj=torch_kmeans(), device="cpu", **RUN)
    seg, hist = read_output(out)
    return dict(inpath=inpath, res=res, seg=seg, hist=hist)


def run_all(commands, env):
    """Start every command, wait for each with a timeout, kill what is
    left. Returns [(returncode, stdout, stderr)]."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO) for cmd in commands]
    try:
        outs = [p.communicate(timeout=WAIT) for p in procs]
    finally:
        # a hung process (a barrier bug) must not leak and hold the port
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def run_driver(tmp_path, env, source, inpath, nproc, localdev=1, tpd=1):
    workdir = tmp_path / "work"
    workdir.mkdir()
    out = str(workdir / "out_dcn.npseg")
    driver = tmp_path / "driver.py"
    driver.write_text(source)
    coord = "127.0.0.1:%d" % free_port()
    results = run_all(
        [[sys.executable, str(driver), coord, str(pid), str(nproc), inpath,
          out, str(localdev), str(tpd)] for pid in range(nproc)], env)
    return out, workdir, results


@pytest.mark.parametrize("nproc,localdev,tpd",
                         [(2, 1, 1), (3, 1, 1), (2, 2, 2)])
def test_dcn_matches_serial(tmp_path, scene, worker_env, nproc, localdev,
                            tpd):
    """2 and 3 processes with one device each, and 2 processes that each
    deal their shard over two local "devices", two tiles at a time."""
    out, workdir, results = run_driver(tmp_path, worker_env, DRIVER,
                                       scene["inpath"], nproc, localdev, tpd)
    for code, stdout, stderr in results:
        assert code == 0, "process failed:\n%s\n%s" % (stdout, stderr)
    seg, hist = read_output(out)
    np.testing.assert_array_equal(seg, scene["seg"])
    np.testing.assert_array_equal(hist, scene["hist"])
    assert scene["res"].maxSegId == int(
        [ln for ln in results[0][1].splitlines()
         if ln.startswith("MAXSEGID")][0].split()[1])
    # every tile went through the shared work directory
    ntiles = scene["res"].numTileRows * scene["res"].numTileCols
    assert len(list(workdir.glob("tile_*.npy"))) == ntiles


def test_dcnworkercmd_matches_serial(tmp_path, worker_env):
    """Two processes of the command line, which fit their own k-means on
    process 0 (fixed init) and broadcast it."""
    inpath = str(tmp_path / "in.npseg")
    make_voronoi_raster(inpath, np.random.default_rng(42), nodata=65535)
    serial = str(tmp_path / "serial.npseg")
    res = tiling.doTiledShepherdSegmentation(
        inpath, serial, tileSize=64, overlapSize=16, minSegmentSize=10,
        numClusters=20, maxSpectralDiff=30.0, fixedKMeansInit=True,
        fourConnected=False, tileGrid='grow', device="cpu")
    workdir = tmp_path / "work"
    workdir.mkdir()
    out = str(workdir / "out.npseg")
    coord = "localhost:%d" % free_port()
    results = run_all([[
        sys.executable, "-m", "pyshepseg_tpu_torch.cmdline.dcnworkercmd",
        "-i", inpath, "-o", out, "-w", str(workdir), "--coordinator", coord,
        "--numprocesses", "2", "--procid", str(pid), "-t", "64", "-l", "16",
        "-m", "10", "-n", "20", "--maxspectraldiff", "30", "--eightway",
        "--fixedkmeansinit", "--tilegrid", "grow", "--format", "KEA",
        "--device", "cpu", "-v"] for pid in range(2)], worker_env)
    for code, stdout, stderr in results:
        assert code == 0, "process failed:\n%s\n%s" % (stdout, stderr)
    assert "Found %d segments" % res.maxSegId in results[0][1]
    assert "Found" not in results[1][1]
    want, got = read_output(serial), read_output(out)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].max() == res.maxSegId > 1


def test_dcn_worker_error_surfaces(tmp_path, worker_env):
    """A worker's failure ships its traceback through the store and fails
    process 0 with PyShepSegDCNError; the failing worker itself ends
    normally, after the last barrier."""
    inpath = str(tmp_path / "in.npseg")
    make_voronoi_raster(inpath, np.random.default_rng(42))
    sabotage = DRIVER.replace("# sabotage", textwrap.dedent("""
        if int(sys.argv[2]) == 1:
            def boom(*a, **k):
                raise RuntimeError('injected shard failure')
            dcn._segmentTileShard = boom
    """))
    _, _, results = run_driver(tmp_path, worker_env, sabotage, inpath, 2)
    assert results[0][0] != 0
    assert "injected shard failure" in results[0][2]
    assert "PyShepSegDCNError" in results[0][2]
    assert "Worker process 1 failed" in results[0][2]
    assert results[1][0] == 0, results[1][2]


def contexts(n, **kwargs):
    """n DistributedContexts of one job in this process (process 0's in a
    thread, as its constructor waits for the others)."""
    coord = "127.0.0.1:%d" % free_port()
    made = [None] * n

    def make(pid):
        made[pid] = dcn.DistributedContext(coord, n, pid, **kwargs)

    threads = [threading.Thread(target=make, args=(pid,))
               for pid in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(c is not None for c in made)
    return made


def shutdown_all(ctxs):
    threads = [threading.Thread(target=c.shutdown) for c in ctxs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(c.store is None for c in ctxs)


def test_context_objects_and_barrier():
    """putObj/getObj carry pickled values under their keys; a barrier
    holds every process until the last has arrived."""
    ctxs = contexts(3, timeoutMs=20000)
    try:
        ctxs[0].putObj("pyshepseg/job/x", {"a": np.arange(4), "b": "text"})
        got = ctxs[2].getObj("pyshepseg/job/x")
        np.testing.assert_array_equal(got["a"], np.arange(4))
        assert got["b"] == "text"

        arrived = []

        def arrive(c):
            c.barrier("pyshepseg_job_b1")
            arrived.append(c.processId)

        threads = [threading.Thread(target=arrive, args=(c,))
                   for c in ctxs[:2]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=1.0)
        assert arrived == [] and all(t.is_alive() for t in threads)
        ctxs[2].barrier("pyshepseg_job_b1")
        for t in threads:
            t.join(timeout=20)
        assert sorted(arrived) == [0, 1]
    finally:
        shutdown_all(ctxs)


def test_context_timeouts(monkeypatch):
    """A key nobody sets and a barrier nobody joins raise after the
    timeout; the environment variable only ever raises the timeout."""
    monkeypatch.setenv("PYSHEPSEG_TPU_DCN_TIMEOUT_MS", "1500")
    ctxs = contexts(2, timeoutMs=300)
    try:
        assert ctxs[0].timeoutMs == ctxs[1].timeoutMs == 1500
        with pytest.raises(Exception, match="(?i)timeout|timed out"):
            ctxs[1].getObj("pyshepseg/job/missing")
        with pytest.raises(Exception, match="(?i)timeout|timed out"):
            ctxs[1].barrier("pyshepseg_job_alone")
    finally:
        shutdown_all(ctxs)
    monkeypatch.setenv("PYSHEPSEG_TPU_DCN_TIMEOUT_MS", "100")
    ctxs = contexts(1, timeoutMs=5000)
    assert ctxs[0].timeoutMs == 5000
    ctxs[0].barrier("pyshepseg_job_single")
    shutdown_all(ctxs)


def test_context_needs_its_address():
    with pytest.raises(ValueError, match="required"):
        dcn.DistributedContext(None, 2, 0)
    with pytest.raises(ValueError, match="required"):
        dcn.DistributedContext("localhost:1", None, None)


def test_local_devices():
    cpu = torch.device("cpu")
    assert dcn._localDevices("cpu", None) == [cpu]
    assert dcn._localDevices("cuda", ["cpu", "cpu"]) == [cpu, cpu]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dcn._localDevices("cuda", None)
        with pytest.raises(RuntimeError):
            dcn.doTiledShepherdSegmentationDistributed(
                "in", "out", "work", coordinatorAddress="localhost:1",
                numProcesses=1, processId=0)
