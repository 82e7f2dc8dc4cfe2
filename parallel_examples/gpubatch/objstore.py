"""
Minimal object-store abstraction for the decoupled batch pipeline
(counterpart: parallel_examples/tpubatch/objstore.py; the reference
implements the same data plane directly against S3 in
parallel_examples/awsbatch/do_prepare.py / do_tile.py / do_stitch.py).
This directory keeps its own copy, so nothing here imports from tpubatch.

Three backends:

- ``file://<dir>`` — a shared filesystem directory (NFS or Lustre on a
  GPU cluster; a tempdir in CI). Always available.
- ``s3://<bucket>/<prefix>`` — S3 via boto3 when installed (the
  reference's data plane); gated, never imported unless used.
- ``gs://<bucket>/<prefix>`` — GCS via google-cloud-storage when
  installed; gated, never imported unless used.

Objects are addressed by simple relative keys. DIRECTORY-shaped
artifacts (the ``.npseg`` datasets the GDAL-less pipeline produces are
directories) are supported on every backend: the cloud backends store
one object per contained file under ``<key>/<relpath>`` and reassemble
on download; the file backend copies the tree with an atomic rename.
"""

import os
import shutil


class ObjectStore:
    """file://, s3:// or gs:// key-value blob store."""

    def __init__(self, url):
        self.url = url.rstrip("/")
        if url.startswith("s3://"):
            import boto3  # gated optional dependency
            rest = url[len("s3://"):]
            self.bucket, _, self.prefix = rest.partition("/")
            self.s3 = boto3.client("s3")
            self.kind = "s3"
        elif url.startswith("gs://"):
            from google.cloud import storage  # gated optional dependency
            rest = url[len("gs://"):]
            bucketName, _, self.prefix = rest.partition("/")
            self.gcs = storage.Client().bucket(bucketName)
            self.kind = "gs"
        elif url.startswith("file://") or "://" not in url:
            path = url[len("file://"):] if url.startswith("file://") else url
            self.root = os.path.abspath(path)
            os.makedirs(self.root, exist_ok=True)
            self.kind = "file"
        else:
            raise ValueError("unsupported object store url: " + url)

    def _key(self, key):
        if self.kind in ("s3", "gs"):
            return (self.prefix + "/" + key).lstrip("/")
        return os.path.join(self.root, key)

    # ---- single-object primitives (cloud backends; overridable in tests)

    def _uploadFile(self, localPath, key):
        if self.kind == "s3":
            self.s3.upload_file(localPath, self.bucket, self._key(key))
        else:
            self.gcs.blob(self._key(key)).upload_from_filename(localPath)

    def _downloadFile(self, key, localPath):
        if self.kind == "s3":
            self.s3.download_file(self.bucket, self._key(key), localPath)
        else:
            self.gcs.blob(self._key(key)).download_to_filename(localPath)

    def _deleteObject(self, key):
        if self.kind == "s3":
            self.s3.delete_object(Bucket=self.bucket, Key=self._key(key))
        else:
            try:
                self.gcs.blob(self._key(key)).delete()
            except Exception:
                pass  # missing object: delete is idempotent, like S3's

    def _listSubKeys(self, key):
        """Relative paths of the objects stored under ``key + '/'``
        (empty for a plain single-object key)."""
        pfx = self._key(key) + "/"
        out = []
        if self.kind == "s3":
            paginator = self.s3.get_paginator("list_objects_v2")
            for page in paginator.paginate(Bucket=self.bucket,
                                           Prefix=pfx):
                for obj in page.get("Contents", []):
                    out.append(obj["Key"][len(pfx):])
        else:
            for blob in self.gcs.list_blobs(prefix=pfx):
                out.append(blob.name[len(pfx):])
        return out

    # ---- public API

    def upload(self, localPath, key):
        if self.kind in ("s3", "gs"):
            if os.path.isdir(localPath):
                # one object per contained file; no cross-object
                # atomicity (same property as the reference's S3 flow —
                # downstream phases gate on the dependency scheduler,
                # not on object visibility)
                for root, _, files in os.walk(localPath):
                    for f in files:
                        full = os.path.join(root, f)
                        rel = os.path.relpath(full, localPath)
                        self._uploadFile(
                            full, key + "/" + rel.replace(os.sep, "/"))
            else:
                self._uploadFile(localPath, key)
            return
        # Atomic: copy into a temp name first, then rename, so a job
        # killed mid-upload never leaves a partial object that a
        # downstream phase would mistake for a complete one.
        dst = self._key(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".uploading.%d" % os.getpid()
        if os.path.isdir(localPath):
            shutil.copytree(localPath, tmp)
        else:
            shutil.copyfile(localPath, tmp)
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        os.replace(tmp, dst)

    def download(self, key, localPath):
        if self.kind in ("s3", "gs"):
            subKeys = self._listSubKeys(key)
            if subKeys:   # directory-shaped artifact
                for rel in subKeys:
                    dst = os.path.join(localPath, *rel.split("/"))
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    self._downloadFile(key + "/" + rel, dst)
            else:
                self._downloadFile(key, localPath)
            return localPath
        src = self._key(key)
        if os.path.isdir(src):
            if os.path.exists(localPath):
                shutil.rmtree(localPath)
            shutil.copytree(src, localPath)
        else:
            shutil.copyfile(src, localPath)
        return localPath

    def delete(self, key):
        if self.kind in ("s3", "gs"):
            for rel in self._listSubKeys(key):
                self._deleteObject(key + "/" + rel)
            self._deleteObject(key)
            return
        p = self._key(key)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.remove(p)
