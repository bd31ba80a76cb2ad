"""Launch entry points (``repro/launch``): the LM prefill step, the serve
CLI and the LM training launcher."""
