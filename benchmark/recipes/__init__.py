"""Volume recipes, one module each, found by a configuration's
`volume.recipe`: make(vol_cfg, seed, device, n_override) -> (density Grid,
temperature Grid or None), made on the device."""
