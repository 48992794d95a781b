"""Several devices and several processes: the chunk mesh (dp only),
ordered gather across processes, and the multi-device dry run."""
