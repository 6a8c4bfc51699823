"""ModelDownloader — model-zoo client with manifest + sha256 verification;
the port's own copy of ``mmlspark_tpu/models/zoo.py``.

Reference: downloader/src/main/scala/ModelDownloader.scala (remote repo with
a MANIFEST of JSON ``.meta`` schemas; sha256-verified download into a
local/HDFS repo; ``downloadByName`` :230-236) and Schema.scala:54-74
(``ModelSchema``: name, dataset, modelType, uri, hash, size, inputNode,
numLayers, layerNames — ``layerNames`` feeds ImageFeaturizer's cut).

Sources: local directories and ``file://`` URIs always work;
``http(s)://`` is attempted via urllib when the environment has egress
(ported, not exercised: the tests and ``chip_smoke.py`` run without
network). A repo is a directory of model payloads plus one
``<name>.meta`` JSON each and a ``MANIFEST`` listing the meta files. A
payload the JAX package published — a saved ``TPUModel`` stage
directory — loads as the port's ``TPUModel``
(``core/serialize.load_stage``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Iterator

from mmlspark_tpu_torch.core.exceptions import FriendlyError

MANIFEST = "MANIFEST"


@dataclass(frozen=True)
class ModelSchema:
    """Self-describing model record (reference Schema.scala:54-74)."""

    name: str
    uri: str  # payload location relative to the repo root (or absolute)
    hash: str  # sha256 hex of the payload archive/dir listing
    size: int = 0
    dataset: str = ""
    model_type: str = ""
    input_node: str = "input"
    num_layers: int = 0
    layer_names: tuple = ()
    extra: dict = field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["layer_names"] = list(self.layer_names)
        return json.dumps(d, indent=1)

    @staticmethod
    def from_json(text: str) -> "ModelSchema":
        d = json.loads(text)
        d["layer_names"] = tuple(d.get("layer_names", ()))
        return ModelSchema(**d)


def _sha256_path(path: str) -> str:
    """sha256 of a file, or of a directory's sorted (relpath, file-sha) list
    (so saved-stage directories can be verified like archives)."""
    h = hashlib.sha256()
    if os.path.isfile(path):
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    for root, _dirs, files in sorted(os.walk(path)):
        for fname in sorted(files):
            rel = os.path.relpath(os.path.join(root, fname), path)
            h.update(rel.encode())
            h.update(_sha256_path(os.path.join(root, fname)).encode())
    return h.hexdigest()


class Repository:
    """A readable model repo (reference ``Repository``/``DefaultModelRepo``,
    ModelDownloader.scala:39-155)."""

    def __init__(self, root: str):
        self.root = root.removeprefix("file://")

    def _read(self, rel: str) -> bytes:
        if self.root.startswith(("http://", "https://")):
            from urllib.parse import quote
            from urllib.request import urlopen

            url = f"{self.root.rstrip('/')}/{quote(rel)}"
            with urlopen(url) as r:  # noqa: S310
                return r.read()
        with open(os.path.join(self.root, rel), "rb") as f:
            return f.read()

    def list_schemas(self) -> Iterator[ModelSchema]:
        try:
            manifest = self._read(MANIFEST).decode()
        except (OSError, FriendlyError) as e:
            raise FriendlyError(f"no MANIFEST under '{self.root}': {e}")
        for line in manifest.splitlines():
            line = line.strip()
            if line:
                yield ModelSchema.from_json(self._read(line).decode())

    def get_schema(self, name: str) -> ModelSchema:
        for schema in self.list_schemas():
            if schema.name == name:
                return schema
        raise FriendlyError(
            f"no model named '{name}' in repo '{self.root}' "
            f"(reference: ModelNotFoundException, ModelDownloader.scala:37)"
        )


class ModelDownloader:
    """Download models into a verified local repo (reference
    ``ModelDownloader``; local repo plays the HDFSRepo role).

    ``retry_limit``/``retry_backoff_s`` mirror the serve engine's
    resilience idiom: a torn read or sha256 mismatch deletes the
    partial payload and RETRIES the fetch (capped deterministic linear
    backoff, no jitter) before surfacing the error — a single transient
    bit-flip on the wire should cost one extra fetch, not a failed
    job."""

    def __init__(self, local_repo: str, remote: str | Repository | None = None,
                 *, retry_limit: int = 3, retry_backoff_s: float = 0.0):
        self.local_repo = local_repo
        os.makedirs(local_repo, exist_ok=True)
        self.remote = (
            remote if isinstance(remote, Repository)
            else Repository(remote) if remote else None
        )
        if retry_limit < 0:
            raise FriendlyError(
                f"retry_limit must be >= 0, got {retry_limit}"
            )
        self.retry_limit = int(retry_limit)
        self.retry_backoff_s = float(retry_backoff_s)

    # -- local side ---------------------------------------------------------

    def local_models(self) -> Iterator[ModelSchema]:
        for fname in sorted(os.listdir(self.local_repo)):
            if fname.endswith(".meta"):
                with open(os.path.join(self.local_repo, fname)) as f:
                    yield ModelSchema.from_json(f.read())

    def local_path(self, schema: ModelSchema) -> str:
        return os.path.join(self.local_repo, schema.uri)

    # -- download -----------------------------------------------------------

    def download_by_name(self, name: str) -> ModelSchema:
        """Fetch by name with sha256 verification; cached when already
        present and intact (ModelDownloader.downloadByName :230-236).
        Transient fetch/verification failures are retried up to
        ``retry_limit`` times with capped deterministic backoff; the
        LAST failure surfaces unchanged."""
        for schema in self.local_models():
            if schema.name == name and self._verify(schema):
                return schema
        if self.remote is None:
            raise FriendlyError(
                f"model '{name}' not in local repo and no remote configured"
            )
        schema = self.remote.get_schema(name)
        attempts = 0
        while True:
            try:
                return self._fetch_verified(schema, name)
            except (FriendlyError, OSError):
                attempts += 1
                if attempts > self.retry_limit:
                    raise
                if self.retry_backoff_s > 0:
                    # deterministic linear backoff, capped at 1s — the
                    # engine's no-jitter reproducibility contract
                    time.sleep(min(self.retry_backoff_s * attempts, 1.0))

    def _fetch_verified(self, schema: ModelSchema, name: str) -> ModelSchema:
        """ONE fetch + sha256 verification attempt; a mismatch deletes
        the partial payload and raises (the retry loop above decides
        whether to go again)."""
        src = os.path.join(self.remote.root, schema.uri)
        dst = self.local_path(schema)
        if os.path.isdir(src):
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
        else:
            # non-filesystem remote: directory payloads list their files in
            # a '<uri>.files' sidecar (written by publish_model)
            try:
                listing = self.remote._read(f"{schema.uri}.files").decode()
                # one path per line (mirrors the publish_model writer);
                # paths may contain spaces
                rels = [ln for ln in listing.splitlines() if ln.strip()]
            except OSError:
                rels = None
            if rels:
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                dst_root = os.path.realpath(dst)
                for rel in rels:
                    fpath = os.path.realpath(os.path.join(dst, rel))
                    # remote-supplied listing: refuse anything escaping the
                    # payload directory (e.g. '../..' traversal)
                    if not fpath.startswith(dst_root + os.sep):
                        raise FriendlyError(
                            f"model '{name}': unsafe path {rel!r} in "
                            f"remote file listing"
                        )
                    os.makedirs(os.path.dirname(fpath), exist_ok=True)
                    with open(fpath, "wb") as f:
                        f.write(self.remote._read(f"{schema.uri}/{rel}"))
            else:
                os.makedirs(
                    os.path.dirname(dst) or self.local_repo, exist_ok=True
                )
                with open(dst, "wb") as f:
                    f.write(self.remote._read(schema.uri))
        if not self._verify(schema):
            # a torn/corrupt payload must NOT linger: a later
            # download_by_name would find the cached bytes, re-hash
            # them, and re-raise forever instead of re-fetching
            actual = (
                _sha256_path(dst) if os.path.exists(dst) else "<missing>"
            )
            if os.path.isdir(dst):
                shutil.rmtree(dst, ignore_errors=True)
            elif os.path.exists(dst):
                os.remove(dst)
            raise FriendlyError(
                f"sha256 mismatch for model '{name}' (corrupt "
                f"download): expected {schema.hash}, got {actual}; "
                "the partial payload was deleted — retry the download"
            )
        with open(os.path.join(self.local_repo, f"{schema.name}.meta"), "w") as f:
            f.write(schema.to_json())
        return schema

    def _verify(self, schema: ModelSchema) -> bool:
        path = self.local_path(schema)
        return os.path.exists(path) and _sha256_path(path) == schema.hash


def publish_model(
    repo_root: str,
    name: str,
    payload_path: str,
    *,
    input_node: str = "input",
    layer_names: tuple = (),
    dataset: str = "",
    model_type: str = "",
    extra: dict | None = None,
) -> ModelSchema:
    """Author-side helper: place a payload (file or saved-stage directory)
    into a repo and regenerate MANIFEST — what the reference's model zoo
    publishing tooling did out-of-band."""
    os.makedirs(repo_root, exist_ok=True)
    base = os.path.basename(payload_path.rstrip("/"))
    dst = os.path.join(repo_root, base)
    if os.path.abspath(payload_path) != os.path.abspath(dst):
        if os.path.isdir(payload_path):
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(payload_path, dst)
        else:
            shutil.copy2(payload_path, dst)
    if os.path.isdir(dst):
        rels = sorted(
            os.path.relpath(os.path.join(r, f), dst)
            for r, _d, fs in os.walk(dst)
            for f in fs
        )
        size = sum(os.path.getsize(os.path.join(dst, rel)) for rel in rels)
        # file-list sidecar: lets http(s) repos fetch directory payloads
        # file-by-file (a filesystem repo just copytrees)
        with open(os.path.join(repo_root, f"{base}.files"), "w") as f:
            f.write("\n".join(rels) + "\n")
    else:
        size = os.path.getsize(dst)
    schema = ModelSchema(
        name=name,
        uri=base,
        hash=_sha256_path(dst),
        size=size,
        dataset=dataset,
        model_type=model_type,
        input_node=input_node,
        layer_names=tuple(layer_names),
        extra=extra or {},
    )
    meta_name = f"{name}.meta"
    with open(os.path.join(repo_root, meta_name), "w") as f:
        f.write(schema.to_json())
    metas = sorted(
        f for f in os.listdir(repo_root) if f.endswith(".meta")
    )
    with open(os.path.join(repo_root, MANIFEST), "w") as f:
        f.write("\n".join(metas) + "\n")
    return schema


def default_downloader() -> ModelDownloader:
    """Downloader wired from the app config namespace (core/config.py):
    ``cache_dir``/models as the local repo, ``model_repo`` as the remote
    (the reference's ``DefaultModelRepo`` role)."""
    from mmlspark_tpu_torch.core import config

    local = os.path.join(config.get("cache_dir"), "models")
    remote = config.get("model_repo") or None
    return ModelDownloader(local, remote=remote)
