"""Host-side data: the mel-spec dataset and the prefetching batch loader."""
