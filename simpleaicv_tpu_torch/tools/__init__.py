"""Command-line entry points of the PyTorch port, run as modules:

    python -m simpleaicv_tpu_torch.tools.train_classification --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_classification --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.train_interactive_segmentation --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_interactive_segmentation --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.train_detr_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.train_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.train_face_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.test_face_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.{train,test}_semantic_segmentation --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.{train,test}_salient_object_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.{train,test}_{face,human}_parsing --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.train_objects365_detection --work-dir <dir>
    python -m simpleaicv_tpu_torch.tools.convert_official_weights --family <f> --network <n> --checkpoint <pth> --out <file>
    python -m simpleaicv_tpu_torch.tools.convert_to_export --work-dir <dir> --output <file.pt2>
    python -m simpleaicv_tpu_torch.tools.run_synthetic_smokes [filter ...]

They run on the card; ``SIMPLEAICV_PLATFORM=cpu`` runs them on the CPU
(the smoke runner always runs on the CPU).
"""
