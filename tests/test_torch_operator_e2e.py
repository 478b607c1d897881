"""The JAX package's control plane drives the port unchanged.

A live ``Manager`` with the ``CronReconciler`` and a thread-isolation
``LocalExecutor``, on the real clock, fires an ``@every 1s`` Cron whose
``kubeflow.org/v1 PyTorchJob`` template names the port's ``generate_job`` by
``module:function``; the workload must reach Succeeded with the port's
progress folded into its status. The same holds for the port's ``gpt``
and ``mnist`` training jobs, for ``mnist`` under subprocess isolation (the
executor's runner resolves the port's ref), and for a checkpointing port
job that is preempted and resumes from its last save.
"""

import torch_threads  # noqa: F401  (an xdist worker's torch threads)

import time

from cron_operator_tpu.api.scheme import GVK_CRON, default_scheme
from cron_operator_tpu.backends.local import LocalExecutor
from cron_operator_tpu.controller import CronReconciler
from cron_operator_tpu.runtime import APIServer, Manager

ENTRYPOINT = "cron_operator_tpu_torch.workloads.entrypoints:generate_job"
GPT_ENTRYPOINT = "cron_operator_tpu_torch.workloads.entrypoints:gpt"
MNIST_ENTRYPOINT = "cron_operator_tpu_torch.workloads.entrypoints:mnist"
GENERATE_PARAMS = {"platform": "cpu", "size": "tiny", "rounds": "1",
                   "max_new": "4", "batch_size": "2", "prompt_len": "4"}


def _cron(entrypoint=ENTRYPOINT, params=GENERATE_PARAMS):
    annotations = {"tpu.kubedl.io/entrypoint": entrypoint}
    annotations.update(
        {f"tpu.kubedl.io/param.{k}": v for k, v in params.items()}
    )
    return {
        "apiVersion": "apps.kubedl.io/v1alpha1", "kind": "Cron",
        "metadata": {"name": "serve-nightly", "namespace": "default"},
        "spec": {
            "schedule": "@every 1s",
            "concurrencyPolicy": "Forbid",
            "template": {"workload": {
                "apiVersion": "kubeflow.org/v1",
                "kind": "PyTorchJob",
                "metadata": {"annotations": annotations},
                "spec": {"replicaSpecs": {"Worker": {"replicas": 1}}},
            }},
        },
    }


def _succeeded(api):
    for job in api.list("kubeflow.org/v1", "PyTorchJob", namespace="default"):
        status = job.get("status") or {}
        types = [c["type"] for c in status.get("conditions") or []]
        if "Succeeded" in types:
            return job
        assert "Failed" not in types, status
    return None


def _run_until_succeeded(cron):
    api = APIServer()
    mgr = Manager(api)
    mgr.add_controller(
        "cron", CronReconciler(api, metrics=mgr.metrics).reconcile,
        for_gvk=GVK_CRON, owns=default_scheme().workload_kinds(),
    )
    executor = LocalExecutor(api, isolation="thread")
    executor.start()
    mgr.start()
    try:
        api.create(cron)
        deadline = time.monotonic() + 60
        job = None
        while job is None and time.monotonic() < deadline:
            time.sleep(0.1)
            job = _succeeded(api)
        assert job is not None, "no PyTorchJob reached Succeeded in 60 s"
        return job["status"]["trainingProgress"]
    finally:
        mgr.stop()
        # A tick that fired just before the manager stopped may leave a job
        # thread registered but not yet started, and stop() joins every
        # registered thread: let the executor go idle first.
        executor.wait_idle(timeout=30.0)
        executor.stop()
        api.close()


def test_cron_runs_the_port_generate_job():
    progress = _run_until_succeeded(_cron())
    assert progress["tokens_generated"] == 8
    assert progress["steps_done"] == 1


def test_cron_runs_the_port_gpt_training_job():
    progress = _run_until_succeeded(_cron(GPT_ENTRYPOINT, {
        "platform": "cpu", "size": "tiny", "steps": "2", "batch_size": "2",
        "seq_len": "32",
    }))
    assert progress["first_step_at"] > 0
    assert progress["steps_done"] == 2


def test_cron_runs_the_port_mnist_training_job():
    progress = _run_until_succeeded(_cron(MNIST_ENTRYPOINT, {
        "platform": "cpu", "steps": "2", "batch_size": "8",
    }))
    assert progress["first_step_at"] > 0
    assert progress["steps_done"] == 2
    assert progress["n_params"] == 535_818


def test_cron_runs_the_port_mnist_job_in_a_subprocess():
    """``tpu.kubedl.io/isolation: subprocess``: the executor spawns its
    runner, which resolves the port's ``module:function`` ref itself, and
    folds the child's progress frames into the status."""
    cron = _cron(MNIST_ENTRYPOINT, {
        "platform": "cpu", "steps": "2", "batch_size": "8",
    })
    cron["spec"]["template"]["workload"]["metadata"]["annotations"][
        "tpu.kubedl.io/isolation"] = "subprocess"
    progress = _run_until_succeeded(cron)
    assert progress["steps_done"] == 2
    assert progress["n_params"] == 535_818


def test_preempted_port_job_resumes_from_its_checkpoint(tmp_path):
    """The executor loop of ``tests/test_checkpoint.py``'s preempt-then-
    resume on a PyTorchJob: preempt a checkpointing port job mid-run; the
    restarted run resumes from the saved step instead of starting over."""
    from cron_operator_tpu.utils.clock import RealClock
    from cron_operator_tpu_torch.workloads.checkpoint import CheckpointStore

    api = APIServer(clock=RealClock())
    ex = LocalExecutor(api)
    ex.start()
    job = {
        "apiVersion": "kubeflow.org/v1",
        "kind": "PyTorchJob",
        "metadata": {
            "name": "mnist-pre", "namespace": "default",
            "annotations": {
                "tpu.kubedl.io/entrypoint": MNIST_ENTRYPOINT,
                "tpu.kubedl.io/restart-on-preemption": "true",
                "tpu.kubedl.io/param.steps": "400",
                "tpu.kubedl.io/param.batch_size": "8",
                "tpu.kubedl.io/param.platform": "cpu",
                "tpu.kubedl.io/param.checkpoint": "1",
                "tpu.kubedl.io/param.save_every": "5",
                "tpu.kubedl.io/param.step_delay_s": "0.01",
                "tpu.kubedl.io/param.checkpoint_dir": str(tmp_path),
            },
        },
        "spec": {"replicaSpecs": {"Worker": {"replicas": 1}}},
    }
    try:
        api.create(job)
        # Wait until some steps are checkpointed.
        deadline = time.time() + 90.0
        progressed = 0
        while time.time() < deadline and progressed < 10:
            store = CheckpointStore("default", "mnist-pre", root=str(tmp_path))
            progressed = store.latest_step() or 0
            store.close()
            time.sleep(0.3)
        assert progressed >= 10, "job never checkpointed progress"

        ex.preempt("default", "mnist-pre", kind="PyTorchJob")
        # The re-run resumes; wait for resumed_from_step to appear.
        deadline = time.time() + 90.0
        resumed = None
        while time.time() < deadline and resumed is None:
            j = api.get("kubeflow.org/v1", "PyTorchJob", "default",
                        "mnist-pre")
            prog = (j.get("status") or {}).get("trainingProgress") or {}
            resumed = prog.get("resumed_from_step")
            time.sleep(0.3)
        assert resumed is not None and resumed >= 10
        assert resumed % 5 == 0
    finally:
        # Cancel the (long) re-run and shut down.
        api.delete("kubeflow.org/v1", "PyTorchJob", "default", "mnist-pre")
        ex.stop()
