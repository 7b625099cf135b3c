"""Logical-axis sharding of the port: the rule table (:mod:`.specs`) and
the activation-sharding context (:mod:`.ctx`), on ``DeviceMesh`` and
DTensor placements."""
