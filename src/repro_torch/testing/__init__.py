"""Testing utilities: deterministic fault injection (``faults``, the port
of ``src/repro/testing``) and the shared inputs of the card checks of the
port's kernels (``kernel_cases``).

Importable by tests and by ``tools/faultinject_torch.py``; it depends on
numpy, torch and the port itself.
"""

from repro_torch.testing.faults import (  # noqa: F401
    CampaignReport,
    CaseResult,
    FaultCase,
    NAMED_ERRORS,
    build_corpus,
    flip_bit,
    run_campaign,
    truncate_file,
)
