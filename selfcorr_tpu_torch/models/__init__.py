"""nn.Modules: ResNet18 + FPN, PointNet, pose/shape heads, correspondence,
MeshNet composition and the eval forward."""
