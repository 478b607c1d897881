"""The JAX package's control plane drives the port unchanged.

A live ``Manager`` with the ``CronReconciler`` and a thread-isolation
``LocalExecutor``, on the real clock, fires an ``@every 1s`` Cron whose
``kubeflow.org/v1 PyTorchJob`` template names the port's ``generate_job`` by
``module:function``; the workload must reach Succeeded with the port's
progress folded into its status. The same holds for the port's ``gpt``
and ``mnist`` training jobs.
"""

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
