"""The LM stack (``repro/models``): the prefill path of the dense and
ssm families."""
