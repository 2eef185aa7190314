"""Host-side pipeline: text processing, audio DSP, synthesis orchestration."""
