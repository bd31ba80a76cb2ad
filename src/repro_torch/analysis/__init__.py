"""Dry-run analysis (``repro/analysis``): the traced cost of a cell
(``cost``), the three-term roofline at the H100's rates (``roofline``)
and the report's tables (``report``)."""
