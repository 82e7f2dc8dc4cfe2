"""Concurrency backends of the port's tiled driver: CONC_THREADS,
CONC_SUBPROC and the scene cache against CONC_NONE, CONC_FARGATE against a
stubbed boto3, worker failures, the configuration checks, and the
subprocess proof that the tiled path, its worker and the run_seg CLI never
import JAX. Port against port: test_torch_tiling.py holds CONC_NONE
against the JAX package."""

import os
import sys
import subprocess

import numpy as np
import pytest
import torch

from pyshepseg_tpu_torch import tiling
from pyshepseg_tpu_torch.cmdline import run_seg
from test_fargate import FakeECS, FakeChan, FakeBarrier
from test_torch_tiling import RUN, make_raster, torch_kmeans
from torch_parity import read_output

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tiled(inpath, outpath, **kw):
    return tiling.doTiledShepherdSegmentation(
        inpath, outpath, kmeansObj=torch_kmeans(), device="cpu",
        **dict(RUN, **kw))


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    """One CONC_NONE run (scene cache 'auto', which the CPU engages)."""
    tmp = tmp_path_factory.mktemp("serial")
    inpath = str(tmp / "in.npseg")
    make_raster(inpath, 42)
    res = run_tiled(inpath, str(tmp / "out.npseg"))
    seg, hist = read_output(str(tmp / "out.npseg"))
    return dict(inpath=inpath, res=res, seg=seg, hist=hist)


def assert_same_as_serial(serial, res, outpath):
    seg, hist = read_output(outpath)
    np.testing.assert_array_equal(seg, serial["seg"])
    np.testing.assert_array_equal(hist, serial["hist"])
    assert res.maxSegId == serial["res"].maxSegId
    assert res.hasEmptySegments == serial["res"].hasEmptySegments


@pytest.mark.parametrize("sceneCache", ['auto', False])
def test_threads_match_serial(serial, tmp_path, sceneCache):
    out = str(tmp_path / "threads.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2,
        tileCompletionTimeout=600, deviceSceneCache=sceneCache)
    res = run_tiled(serial["inpath"], out, concurrencyCfg=cfg)
    assert_same_as_serial(serial, res, out)
    assert res.timings.getDurationsForName('segmentation')


@pytest.mark.parametrize("sceneCache", [True, False])
def test_scene_cache_setting_matches_auto(serial, tmp_path, sceneCache):
    out = str(tmp_path / "cache.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(deviceSceneCache=sceneCache)
    res = run_tiled(serial["inpath"], out, concurrencyCfg=cfg)
    assert_same_as_serial(serial, res, out)


def test_scene_cache_engages_and_slices(serial):
    """'auto' engages on the CPU; a tile from the cache is a uint16 view
    of the scene tensor that equals the raster read."""
    inDs = tiling.rio.open(serial["inpath"])
    assert tiling.DeviceSceneCache.fitsOnDevice(inDs, [1, 2, 3], "cpu")
    cache = tiling.DeviceSceneCache(inDs, [1, 2, 3], "cpu")
    tile = cache.getTile(48, 86, 64, 64)
    assert tuple(tile.shape) == (3, 64, 64)
    want = np.array([inDs.GetRasterBand(b).ReadAsArray(48, 86, 64, 64)
                     for b in (1, 2, 3)])
    np.testing.assert_array_equal(tile.numpy(), want)


def test_subproc_matches_serial(serial, tmp_path, monkeypatch):
    """CONC_SUBPROC drives the remote-worker protocol (TCP channel,
    pickled tiles and results, barrier, queues, timing merge) with two
    local worker processes. Their PYTHONPATH starts with a ``jax`` package
    that raises when imported, and PYSHEPSEG_TPU_PLATFORM is set (with it,
    loading the JAX package imports jax), so a worker that imports JAX or
    the JAX package fails the run through the channel's exception
    queue."""
    poison = tmp_path / "poison" / "jax"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('the port worker imported jax')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(poison.parent), REPO, os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYSHEPSEG_TPU_PLATFORM", "cpu")
    out = str(tmp_path / "subproc.npseg")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_SUBPROC, numWorkers=2,
        tileCompletionTimeout=300, barrierTimeout=120)
    res = run_tiled(serial["inpath"], out, concurrencyCfg=cfg)
    assert_same_as_serial(serial, res, out)
    # worker timings merged back over the channel
    assert "segmentation" in res.timings.makeSummaryDict()


def test_threads_worker_exception_surfaces(serial, tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("injected worker failure")

    monkeypatch.setattr(tiling.shepseg, "doShepherdSegmentation", boom)
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2,
        tileCompletionTimeout=5)
    with pytest.raises(tiling.PyShepSegTilingError):
        run_tiled(serial["inpath"], str(tmp_path / "out.npseg"),
                  concurrencyCfg=cfg)


def _fargate_mgr(monkeypatch, ecs, numWorkers=2):
    import types
    fake_boto3 = types.ModuleType("boto3")
    fake_boto3.client = lambda name: ecs
    monkeypatch.setitem(sys.modules, "boto3", fake_boto3)
    fargateCfg = tiling.FargateConfig(
        containerImage="repo/image:latest", taskRoleArn="arn:role/task",
        executionRoleArn="arn:role/exec", subnet="subnet-1",
        securityGroups=["sg-1"], cloudwatchLogGroup="/my/group")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_FARGATE, numWorkers=numWorkers,
        fargateCfg=fargateCfg, barrierTimeout=5)
    mgr = tiling.SegFargateMgr.__new__(tiling.SegFargateMgr)
    mgr.concurrencyCfg = cfg
    mgr.dataChan = FakeChan()
    mgr.workerBarrier = FakeBarrier()
    return mgr


def test_fargate_start_and_shutdown(monkeypatch, capsys):
    ecs = FakeECS(exitCodes=(0, 3))
    mgr = _fargate_mgr(monkeypatch, ecs)
    mgr.startWorkers()
    names = [c[0] for c in ecs.calls]
    assert names[:2] == ["create_cluster", "register_task_definition"]
    assert names.count("run_task") == 2
    assert mgr.workerBarrier.waited
    cdef = dict(ecs.calls[1][1])["containerDefinitions"][0]
    # the container runs the port's worker
    assert cdef["entryPoint"] == ["pyshepseg_tpu_torch_segmentationworkercmd"]
    assert cdef["logConfiguration"]["options"]["awslogs-group"] == "/my/group"
    runs = [c[1] for c in ecs.calls if c[0] == "run_task"]
    for i, kwargs in enumerate(runs):
        cmd = kwargs["overrides"]["containerOverrides"][0]["command"]
        assert cmd == ["--idnum", str(i), "--channaddr", "host,1234,abcd"]
    mgr.shutdown()
    names = [c[0] for c in ecs.calls]
    assert names[-2:] == ["deregister_task_definition", "delete_cluster"]
    assert "exited with 3" in capsys.readouterr().err.replace("\n", " ")


def test_fargate_requires_boto3(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    mgr = tiling.SegFargateMgr.__new__(tiling.SegFargateMgr)
    with pytest.raises(tiling.PyShepSegTilingError):
        mgr.specificChecks()


@pytest.mark.parametrize("kwargs", [
    dict(concurrencyType=tiling.CONC_FARGATE),
    dict(fargateCfg=tiling.FargateConfig()),
    dict(deviceSceneCache="bogus"),
    dict(tilesPerDevice=0),
    dict(tilesPerDevice=1.5),
    dict(tilesPerDevice="2"),
    dict(workerDevices="some"),
])
def test_config_validation(kwargs):
    with pytest.raises(tiling.PyShepSegTilingError):
        tiling.SegmentationConcurrencyConfig(**kwargs)


def test_config_normalises_scene_cache_flag():
    assert tiling.SegmentationConcurrencyConfig(
        deviceSceneCache=1).deviceSceneCache is True
    assert tiling.SegmentationConcurrencyConfig(
        deviceSceneCache=0).deviceSceneCache is False


@pytest.mark.parametrize("concType,kwargs,exc", [
    (tiling.CONC_THREADS, {}, tiling.PyShepSegTilingError),
    (tiling.CONC_NONE, dict(overlapSize=15), tiling.PyShepSegTilingError),
    (tiling.CONC_MESH, dict(overlapSize=15), tiling.PyShepSegTilingError),
    ("CONC_OTHER", {}, ValueError),
])
def test_driver_rejects_bad_setup(serial, tmp_path, concType, kwargs, exc):
    """No workers for CONC_THREADS, an odd overlap (CONC_NONE and
    CONC_MESH) and an unknown backend."""
    cfg = tiling.SegmentationConcurrencyConfig(concurrencyType=concType)
    with pytest.raises(exc):
        run_tiled(serial["inpath"], str(tmp_path / "out.npseg"),
                  concurrencyCfg=cfg, **kwargs)


def test_scene_cache_forced_on_subproc_rejected():
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_SUBPROC, numWorkers=1,
        deviceSceneCache=True)
    mgr = tiling.SegSubprocMgr.__new__(tiling.SegSubprocMgr)
    mgr.concurrencyCfg = cfg
    with pytest.raises(tiling.PyShepSegTilingError):
        mgr.maybeBuildSceneCache()


def test_run_seg_sharded_raises(serial, tmp_path, monkeypatch):
    """``run_seg --sharded`` runs the row-sharded pipeline: on the CPU its
    output equals the unsharded command's; with the default ``--device
    cuda`` it raises where there is no CUDA device, and never moves to the
    CPU by itself."""
    args = ["-i", serial["inpath"], "-n", "20", "-b", "1,2,3", "-s", "10",
            "-m", "30", "-c", "10", "--fixedkmeansinit"]
    outs = []
    for extra in ([], ["--sharded"]):
        out = str(tmp_path / ("out%d.npseg" % len(outs)))
        monkeypatch.setattr(sys, "argv", ["run_seg", "-o", out, "--device",
                                          "cpu"] + args + extra)
        run_seg.mainCmd()
        outs.append(tiling.rio.open(out).GetRasterBand(1).ReadAsArray())
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[0].max() > 1
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", [
            "run_seg", "-o", str(tmp_path / "cuda.npseg"), "--sharded"]
            + args)
        with pytest.raises(RuntimeError, match="is_available"):
            run_seg.mainCmd()


def test_tiled_path_and_cli_never_import_jax(tmp_path):
    """A fresh interpreter runs a tiny tiled segmentation (CONC_NONE,
    CONC_MESH over two CPU devices and the 3-phase API), the row-sharded
    pipeline and ``run_seg --sharded``, the stats pass on both engines, subsetImage, and
    the run_seg, tiling, variograms, subset and runtests CLIs on the CPU
    with PYSHEPSEG_TPU_PLATFORM set; neither JAX nor the JAX package may
    be imported, the run_seg CLI's output must equal
    doShepherdSegmentation's, the tiling CLI's stats columns the stats
    pass's, the subset CLI's output subsetImage's, and runtests must
    exit 0."""
    code = f"""
import sys
import numpy as np
from pyshepseg_tpu_torch import io as rio, shepseg, subset, tiling
from pyshepseg_tpu_torch import tilingstats
from pyshepseg_tpu_torch.cmdline import run_seg, runtests, variograms
from pyshepseg_tpu_torch.cmdline import subset as subset_cli
from pyshepseg_tpu_torch.cmdline import tiling as tiling_cli
from pyshepseg_tpu_torch.parallel import mesh, shardmap_seg
d = {str(tmp_path)!r}
rng = np.random.default_rng(0)
img = (100 + 40 * rng.integers(0, 6, size=(1, 20, 24))).repeat(8, 1)
img = np.repeat(img.repeat(3, 0), 4, 2).astype(np.uint16)
ds = rio.create(d + '/in.npseg', img.shape[2], img.shape[1], 3, np.uint16)
for b in range(3):
    ds.GetRasterBand(b + 1).WriteArray(img[b])
ds.FlushCache()
res = tiling.doTiledShepherdSegmentation(
    d + '/in.npseg', d + '/tiled.npseg', tileSize=64, overlapSize=16,
    numClusters=6, minSegmentSize=5, fixedKMeansInit=True, device='cpu')
assert res.maxSegId > 0 and not res.hasEmptySegments
mesh.SegMeshMgr.meshDevices = ['cpu', 'cpu']
resm = tiling.doTiledShepherdSegmentation(
    d + '/in.npseg', d + '/mesh.npseg', tileSize=64, overlapSize=16,
    kmeansObj=res.kmeans, minSegmentSize=5, device='cpu',
    concurrencyCfg=tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, tilesPerDevice=2))
assert resm.maxSegId == res.maxSegId
assert (rio.open(d + '/mesh.npseg').GetRasterBand(1).ReadAsArray() ==
        rio.open(d + '/tiled.npseg').GetRasterBand(1).ReadAsArray()).all()
prep = tiling.doTiledShepherdSegmentation_prepare(
    d + '/in.npseg', tileSize=64, overlapSize=16, kmeansObj=res.kmeans,
    device='cpu')
tiling.doTiledShepherdSegmentation_doOne(
    prep[0], d + '/tile.npseg', prep[5], 0, 0, prep[1], prep[4], prep[2],
    minSegmentSize=5, device='cpu')
sys.argv = ['run_seg', '-i', d + '/in.npseg', '-o', d + '/cli.npseg',
            '-n', '6', '-b', '1,2,3', '-s', '5', '-c', '100',
            '--fixedkmeansinit', '--device', 'cpu']
run_seg.mainCmd()
cli = rio.open(d + '/cli.npseg').GetRasterBand(1).ReadAsArray()
want_res = shepseg.doShepherdSegmentation(
    img, numClusters=6, clusterSubsamplePcnt=100, minSegmentSize=5,
    fixedKMeansInit=True, device='cpu')
want = want_res.segimg
assert (cli == want).all()
sys.argv = sys.argv[:4] + [d + '/clis.npseg'] + sys.argv[5:] + ['--sharded']
run_seg.mainCmd()
clis = rio.open(d + '/clis.npseg').GetRasterBand(1).ReadAsArray()
assert (clis == want).all()
km = want_res.kmeans
sharded, _ = shardmap_seg.segment_image_sharded(
    img, km.cluster_centers_, maxSpectralDiff=float(
        shepseg.autoMaxSpectralDiff(km, 'auto', 50)), minSegmentSize=5,
    mesh=['cpu'] * 4)
assert (sharded == want).all()
sel = [('m', 'mean'), ('p', 'percentile', 50)]
for engine in ('device', 'host'):
    tilingstats.calcPerSegmentStatsTiled(
        d + '/in.npseg', 2, d + '/tiled.npseg',
        [(n + engine, *rest) for n, *rest in sel], engine=engine,
        device='cpu')
sys.argv = ['tiling', '-i', d + '/in.npseg', '-o', d + '/tcli.npseg',
            '-n', '6', '-b', '1,2,3', '-s', '5', '-t', '64', '-l', '16',
            '--fixedkmeansinit', '--statsbands', '2', '--statspec', 'mean',
            '--statspec', 'percentile,50', '--device', 'cpu']
tiling_cli.mainCmd()
def cols(path):
    rat = rio.open(path).GetRasterBand(1).GetDefaultRAT()
    return {{rat.GetNameOfCol(i): rat.ReadAsArray(i)
            for i in range(rat.GetColumnCount())}}
c, t = cols(d + '/tiled.npseg'), cols(d + '/tcli.npseg')
assert (c['mdevice'] == c['mhost']).all() and (c['pdevice'] == c['phost']).all()
assert (t['Band_2_mean'] == c['mhost']).all()
assert (t['Band_2_pcnt50'] == c['phost']).all()
rio.open(d + '/in.npseg', rio.GA_Update).GetRasterBand(1).SetNoDataValue(0)
sys.argv = ['variograms', '-i', d + '/in.npseg', '-s', d + '/tcli.npseg',
            '-n', '2', '--device', 'cpu']
variograms.mainCmd()
assert 'variogram2' in cols(d + '/tcli.npseg')
subset.subsetImage(d + '/tcli.npseg', d + '/sub.npseg', 8, 4, 48, 40, None,
                   origSegIdColName='orig')
sys.argv = ['subset', '-i', d + '/tcli.npseg', '-o', d + '/subcli.npseg',
            '--srcwin', '8', '4', '48', '40', '--origsegidcol', 'orig']
subset_cli.mainCmd()
s, c = cols(d + '/sub.npseg'), cols(d + '/subcli.npseg')
assert all((s[k] == c[k]).all() for k in s) and s.keys() == c.keys()
sys.argv = ['runtests', '-d', d, '--device', 'cpu', '--size', '100',
            '--ncentres', '8', '--tilesize', '64', '--overlapsize', '16']
try:
    runtests.mainCmd()
except SystemExit as e:
    assert e.code == 0, e.code
assert 'jax' not in sys.modules, 'jax imported'
assert 'pyshepseg_tpu' not in sys.modules, 'pyshepseg_tpu imported'
print('ok')
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PYSHEPSEG_TPU_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
