#!/usr/bin/env python
"""
Submit the three-phase decoupled segmentation pipeline
(prepare -> array of tile jobs -> stitch) to an execution backend.
GPU counterpart of parallel_examples/tpubatch/submit_pyshepseg_job.py
(and of the reference's parallel_examples/awsbatch/submit-pyshepseg-job.py,
which wires the same DAG through AWS Batch job dependencies).

Backends:

- ``local``   — run every phase as local subprocesses, tile jobs with a
  bounded pool. Exercises the exact pipeline end-to-end on one machine
  (the batch analogue of tiling's CONC_SUBPROC test backend). A phase
  that fails ends the run with a non-zero exit: the stitch never runs
  over a missing tile.
- ``slurm``   — emit (and optionally run) sbatch scripts: one prepare
  job, one array job of tiles (--array=0-N-1, one GPU each via
  ``--gres=gpu:1``), one dependent stitch job.
- ``gcpbatch``— emit gcloud batch JSON job specs with taskCount=N for
  the tile phase on a GPU machine type with one NVIDIA accelerator.

For slurm/gcpbatch the emitted artifacts are written to --emit-dir for
review/submission; this script does not talk to cloud APIs itself.

``--device`` is passed to all three phases (the k-means fit, every tile,
the statistics pass); with ``--device cpu`` the emitted specs ask for no
GPU.
"""

import argparse
import os
import re
import subprocess
import sys
from concurrent import futures

HERE = os.path.dirname(os.path.abspath(__file__))


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backend", default="local",
                   choices=["local", "slurm", "gcpbatch"])
    p.add_argument("--infile", required=True)
    p.add_argument("--store", required=True, help="Object store URL")
    p.add_argument("--outname", default="segmentation.npseg")
    p.add_argument("--tilesize", type=int, default=4096)
    p.add_argument("--overlapsize", type=int, default=1024)
    p.add_argument("--nclusters", type=int, default=60)
    p.add_argument("--bands")
    p.add_argument("--fixedkmeansinit", action="store_true", default=False)
    p.add_argument("--minsegmentsize", type=int, default=50)
    p.add_argument("--maxspectraldiff", default="auto")
    p.add_argument("--eightway", action="store_true", default=False)
    p.add_argument("--spectdistpcntile", type=int, default=50)
    p.add_argument("--statsbands")
    p.add_argument("--device", default="cuda",
                   help="Torch device of every phase: 'cuda' (a phase "
                        "raises when CUDA is absent), 'cuda:N' or 'cpu' "
                        "(default=%(default)s)")
    p.add_argument("--workers", type=int, default=4,
                   help="local backend: concurrent tile subprocesses "
                        "(each is a CUDA context of its own on the card)")
    p.add_argument("--emit-dir", default="batch_jobs",
                   help="slurm/gcpbatch: where to write job artifacts")
    p.add_argument("--machine-type", default="a3-highgpu-1g",
                   help="gcpbatch: GPU machine type when no "
                        "--instance-template is given")
    p.add_argument("--accelerator-type", default="nvidia-h100-80gb",
                   help="gcpbatch: the NVIDIA accelerator of that machine "
                        "type (one a task)")
    p.add_argument("--instance-template",
                   help="gcpbatch: worker instance template")
    p.add_argument("--container-image",
                   help="gcpbatch: worker container (the Makefile's "
                        "pushed image); default runs the phase scripts "
                        "directly on the VM image")
    return p.parse_args()


def _phaseArgs(cmdargs):
    """(prepareArgs, tileArgs, stitchArgs) as argument lists — every user
    option, so each backend runs the phases identically."""
    common = ["--store", cmdargs.store, "--device", cmdargs.device]
    prep = ["--infile", cmdargs.infile] + common + [
        "--tilesize", str(cmdargs.tilesize),
        "--overlapsize", str(cmdargs.overlapsize),
        "--nclusters", str(cmdargs.nclusters)]
    if cmdargs.bands:
        prep += ["--bands", cmdargs.bands]
    if cmdargs.fixedkmeansinit:
        prep += ["--fixedkmeansinit"]
    tiles = common + [
        "--minsegmentsize", str(cmdargs.minsegmentsize),
        "--maxspectraldiff", str(cmdargs.maxspectraldiff),
        "--spectdistpcntile", str(cmdargs.spectdistpcntile)]
    if cmdargs.eightway:
        tiles += ["--eightway"]
    stitch = common + ["--outname", cmdargs.outname]
    if cmdargs.statsbands:
        stitch += ["--statsbands", cmdargs.statsbands]
    return prep, tiles, stitch


def _run(cmd):
    """Run one phase job and echo its output; a job that fails ends the
    whole submission with its exit code."""
    print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, capture_output=True, text=True)
    print(res.stdout, flush=True)
    if res.returncode != 0:
        print(res.stderr, file=sys.stderr, flush=True)
        raise SystemExit("job failed with exit code {}: {}".format(
            res.returncode, " ".join(cmd)))
    return res.stdout


def submit_local(cmdargs):
    py = sys.executable
    prep, tiles, stitch = _phaseArgs(cmdargs)
    out = _run([py, os.path.join(HERE, "do_prepare.py")] + prep)
    numTiles = int(re.search(r"NUMTILES=(\d+)", out).group(1))

    def tileJob(i):
        _run([py, os.path.join(HERE, "do_tile.py")] + tiles +
             ["--index", str(i)])

    # reading every result re-raises a failed job's SystemExit here, so
    # the stitch below never runs over a missing tile
    with futures.ThreadPoolExecutor(cmdargs.workers) as pool:
        list(pool.map(tileJob, range(numTiles)))

    _run([py, os.path.join(HERE, "do_stitch.py")] + stitch)
    print("pipeline complete:", cmdargs.store + "/" + cmdargs.outname)


SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={name}_%A_%a.log
{gres}
python {script} {args}
"""

# Array size and dependencies are only known at submission time (the
# prepare job computes NUMTILES), so they are passed as sbatch
# command-line options — which override in-file directives — by this
# orchestrator rather than baked into the scripts.
SLURM_SUBMIT_ALL = """#!/bin/bash
# Submit the three-phase pipeline with real job-id dependencies.
set -euo pipefail
cd "$(dirname "$0")"

# Phase 1: prepare (run synchronously so we learn the tile count)
prep_id=$(sbatch --parsable --wait psseg_prepare.sbatch)
# || true: under pipefail a missing log operand (only one of the two
# name shapes exists, array vs non-array %a expansion) or a no-match
# grep would abort the script before the diagnostic below
numtiles=$(cat psseg_prepare_${prep_id}_*.log \\
               psseg_prepare_${prep_id}.log 2>/dev/null \\
           | grep -oP 'NUMTILES=\\K\\d+' | head -1 || true)
if [ -z "${numtiles}" ]; then
    echo "could not find NUMTILES in the prepare job log" >&2
    exit 1
fi

# Phase 2: one array task per tile
tiles_id=$(sbatch --parsable --array=0-$((numtiles - 1)) \\
           psseg_tiles.sbatch)

# Phase 3: stitch after every tile job succeeded
sbatch --dependency=afterok:${tiles_id} psseg_stitch.sbatch
"""


def submit_slurm(cmdargs):
    os.makedirs(cmdargs.emit_dir, exist_ok=True)
    prep, tiles, stitch = _phaseArgs(cmdargs)
    # one GPU a job (the k-means fit, a tile, the statistics pass)
    gres = "" if cmdargs.device == "cpu" else "#SBATCH --gres=gpu:1\n"
    jobs = [
        ("psseg_prepare", "do_prepare.py", prep),
        ("psseg_tiles", "do_tile.py", tiles),
        ("psseg_stitch", "do_stitch.py", stitch),
    ]
    for name, script, args in jobs:
        body = SLURM_TEMPLATE.format(
            name=name, gres=gres, script=os.path.join(HERE, script),
            args=" ".join(args))
        path = os.path.join(cmdargs.emit_dir, name + ".sbatch")
        with open(path, "w") as f:
            f.write(body)
        print("wrote", path)
    submitAll = os.path.join(cmdargs.emit_dir, "submit_all.sh")
    with open(submitAll, "w") as f:
        f.write(SLURM_SUBMIT_ALL)
    os.chmod(submitAll, 0o755)
    print("wrote", submitAll)
    print("Run submit_all.sh to submit the DAG (array size and job-id "
          "dependencies are wired at submission time).")


# Script variant: runs the phase scripts from a VM image that carries
# them and the installed package. --instance-template points the
# allocationPolicy at a worker shape administered elsewhere;
# --container-image switches the runnable to the worker container built
# by the Makefile.
GCP_TEMPLATE = """{{
  "taskGroups": [{{
    "taskCount": "{count}",
    "taskSpec": {{
      "runnables": [{{
        {runnable}
      }}]
    }}
  }}],
  "allocationPolicy": {{
    "instances": [{{ {instances} }}]
  }},
  "logsPolicy": {{ "destination": "CLOUD_LOGGING" }}
}}
"""

GCP_RUNNABLE_SCRIPT = '"script": {{ "text": "python {script} {args}" }}'
GCP_RUNNABLE_CONTAINER = ('"container": {{ "imageUri": "{image}", '
                          '"commands": ["{script}"{argitems}] }}')


def submit_gcpbatch(cmdargs):
    os.makedirs(cmdargs.emit_dir, exist_ok=True)
    prep, tiles, stitch = _phaseArgs(cmdargs)
    specs = [
        ("psseg_prepare", "do_prepare.py", 1, prep),
        ("psseg_tiles", "do_tile.py", "NUMTILES", tiles),
        ("psseg_stitch", "do_stitch.py", 1, stitch),
    ]
    if cmdargs.instance_template:
        instances = ('"instanceTemplate": "{}"'
                     .format(cmdargs.instance_template))
    elif cmdargs.device == "cpu":
        instances = ('"policy": {{ "machineType": "{}" }}'
                     .format(cmdargs.machine_type))
    else:
        instances = ('"installGpuDrivers": true, "policy": '
                     '{{ "machineType": "{}", "accelerators": '
                     '[{{ "type": "{}", "count": 1 }}] }}'
                     .format(cmdargs.machine_type,
                             cmdargs.accelerator_type))
    for name, script, count, args in specs:
        if cmdargs.container_image:
            # container workers run the scripts at the image's WORKDIR
            argitems = "".join(', "{}"'.format(a) for a in args)
            runnable = GCP_RUNNABLE_CONTAINER.format(
                image=cmdargs.container_image, script=script,
                argitems=argitems)
        else:
            runnable = GCP_RUNNABLE_SCRIPT.format(
                script=os.path.join(HERE, script), args=" ".join(args))
        path = os.path.join(cmdargs.emit_dir, name + ".json")
        with open(path, "w") as f:
            f.write(GCP_TEMPLATE.format(
                count=count, runnable=runnable, instances=instances))
        print("wrote", path)
    print("Submit with: gcloud batch jobs submit <name> "
          "--config <spec>.json (set taskCount from the prepare output; "
          "BATCH_TASK_INDEX indexes the tiles).")


def main():
    cmdargs = getCmdargs()
    if cmdargs.backend == "local":
        submit_local(cmdargs)
    elif cmdargs.backend == "slurm":
        submit_slurm(cmdargs)
    else:
        submit_gcpbatch(cmdargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
