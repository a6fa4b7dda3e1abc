"""The LM stack's mesh: logical-axis sharding rules over a DeviceMesh."""
