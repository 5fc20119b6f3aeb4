from .fmindex import FMIndex, Annotation, ReferenceMeta  # noqa: F401
from .build import build_index, index_fasta  # noqa: F401
