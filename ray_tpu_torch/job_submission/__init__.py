"""Job submission: run an entrypoint script on the cluster under a supervisor.

Reference: `dashboard/modules/job/job_manager.py:490` (`JobManager` runs each
job's entrypoint as a supervisor-actor-managed subprocess with its runtime
env) + the thin SDK `python/ray/job_submission/`. Same model here:

  client = JobSubmissionClient()            # in-proc or address="host:port"
  job_id = client.submit_job(entrypoint="python train.py",
                             runtime_env={"working_dir": "..."})
  client.get_job_status(job_id)             # PENDING/RUNNING/SUCCEEDED/FAILED
  client.get_job_logs(job_id)

The supervisor actor execs the entrypoint with RAY_TPU_TORCH_ADDRESS /
RAY_TPU_TORCH_AUTHKEY_HEX exported, so the script joins this cluster as a client
driver; job state + logs live in the GCS KV.
"""

from ray_tpu_torch.job_submission.client import JobStatus, JobSubmissionClient

__all__ = ["JobSubmissionClient", "JobStatus"]
