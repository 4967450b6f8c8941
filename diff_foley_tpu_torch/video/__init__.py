"""Video ingest and A/V muxing (``diff_foley_tpu/video``)."""
