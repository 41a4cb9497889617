"""The S3-shaped object store: the port's copy of ccfd_tpu/store/."""

from ccfd_tpu_torch.store.objectstore import Credentials, ObjectStore  # noqa: F401
