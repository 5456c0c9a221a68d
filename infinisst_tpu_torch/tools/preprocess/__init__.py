"""Data preprocessing tools; port of ``infinisst_tpu/tools/preprocess``.

The modules are copies of the JAX package's (which import no JAX), with
their imports pointed at this package: TSV and wav helpers (``utils``),
the Whisper ASR filter (``asr_filter``), MFA corpus dumps (``prep_mfa``),
trajectory building (``build_trajectory``), speaker-tag removal
(``remove_speakers``) and the streaming-eval inputs
(``prepare_simuleval_inputs``).  Run each as
``python -m infinisst_tpu_torch.tools.preprocess.<module> --help``.
"""
