"""Exception types of the PyTorch package.

Same hierarchy and names as the JAX package's ``petastorm_tpu.errors``, so
callers catch the same kinds of failure from either package.
"""


class PetastormTpuError(Exception):
    """Base class for all framework errors."""


class MetadataError(PetastormTpuError):
    """Dataset metadata is missing or malformed."""


class MetadataGenerationError(PetastormTpuError):
    """Metadata could not be generated for the dataset."""


class NoDataAvailableError(PetastormTpuError):
    """A shard or filtered view of the dataset contains no row groups."""


class SchemaError(PetastormTpuError):
    """A value does not conform to its UnischemaField declaration."""
