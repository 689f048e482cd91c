"""Host mirror of the cluster, its objects, and the snapshot packer."""
