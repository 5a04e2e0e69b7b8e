"""Sample-quality and text-conditioning metrics (``metrics``)."""
